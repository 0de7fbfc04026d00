"""The read port's check routes over a port engine (stdlib ``http.server``).

The JAX package's ``server/rest.py`` check surface (`read_router`), with
the reference's status quirks (`check/handler.go`):

  GET/POST /relation-tuples/check            403 on deny (handler.go:121-154)
  GET/POST /relation-tuples/check/openapi    always 200 (handler.go:99-110)

Bodies are ``{"allowed": bool}``; errors are herodot-shaped
``{"error": {"code", "status", "message"}}``.  An unknown namespace
answers ``allowed: false`` (handler.go:169-171).  Config loading, the write
API and gRPC are not part of this server.
"""

from __future__ import annotations

import json
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict
from urllib.parse import parse_qs, urlsplit

from ketotpu_torch.api.types import (
    BadRequestError,
    KetoAPIError,
    NotFoundError,
    RelationTuple,
)

_STATUS_TEXT = {
    200: "OK",
    400: "Bad Request",
    403: "Forbidden",
    404: "Not Found",
    405: "Method Not Allowed",
    500: "Internal Server Error",
}

_ROUTES = {
    "/relation-tuples/check": True,  # path -> 403-mirror
    "/relation-tuples/check/openapi": False,
}


def _error_body(code: int, message: str) -> dict:
    return {
        "error": {
            "code": code,
            "status": _STATUS_TEXT.get(code, "error"),
            "message": message,
        }
    }


def _max_depth(q: Dict[str, str]) -> int:
    """x/max_depth.go:13-24 parity: Go base-0 integer syntax (hex "0x10" is
    16, a bare leading zero "010" is octal 8)."""
    if "max-depth" not in q:
        return 0
    s = q["max-depth"]
    try:
        return int(s, 0)
    except ValueError:
        core = s.lstrip("+-")
        if core.startswith("0") and core.isdigit():
            try:
                v = int(core, 8)
            except ValueError:
                pass
            else:
                return -v if s.startswith("-") else v
        raise BadRequestError(
            f"unable to parse 'max-depth' query parameter to int: "
            f"invalid syntax {s!r}"
        ) from None


def check_route(engine, method: str, path: str, query: Dict[str, str],
                body: bytes):
    """(status, json body) of one check request."""
    mirror = _ROUTES.get(path)
    if mirror is None:
        return 404, _error_body(404, f"no route for {path}")
    if method not in ("GET", "POST"):
        return 405, _error_body(405, f"method {method} not allowed")
    try:
        if method == "GET":
            tuple_ = RelationTuple.from_url_query(query)
        else:
            try:
                data = json.loads(body or b"{}")
            except ValueError as e:
                raise BadRequestError(f"could not unmarshal json: {e}") from None
            if not isinstance(data, dict):
                raise BadRequestError("could not unmarshal json: not an object")
            tuple_ = RelationTuple.from_json(data)
        try:
            allowed = bool(engine.check_is_member(tuple_, _max_depth(query)))
        except NotFoundError:
            allowed = False  # check/handler.go:169-171
    except KetoAPIError as e:
        return e.status_code, _error_body(e.status_code, e.message)
    return (403 if mirror and not allowed else 200), {"allowed": allowed}


def make_server(engine, host: str = "127.0.0.1", port: int = 4466) -> ThreadingHTTPServer:
    """An HTTP server answering the check routes from ``engine`` (anything
    with ``check_is_member(tuple, max_depth)``).  The caller runs
    ``serve_forever()`` and ends it with ``shutdown()`` + ``server_close()``;
    ``server_address`` holds the bound port (pass 0 for any free one)."""

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _handle(self, method: str) -> None:
            parts = urlsplit(self.path)
            query = {k: v[0] for k, v in parse_qs(
                parts.query, keep_blank_values=True).items()}
            n = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(n) if n else b""
            status, payload = check_route(engine, method, parts.path, query, body)
            data = json.dumps(payload).encode()
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def do_GET(self):  # noqa: N802 — http.server's hook names
            self._handle("GET")

        def do_POST(self):  # noqa: N802
            self._handle("POST")

        def log_message(self, format, *args):  # noqa: A002 — quiet access log
            pass

    return ThreadingHTTPServer((host, port), Handler)
