"""The read port's check and expand routes over a port engine (stdlib
``http.server``).

The JAX package's ``server/rest.py`` check and expand surface
(`read_router`), with the reference's status quirks (`check/handler.go`,
`expand/handler.go`):

  GET/POST /relation-tuples/check            403 on deny (handler.go:121-154)
  GET/POST /relation-tuples/check/openapi    always 200 (handler.go:99-110)
  GET      /relation-tuples/expand           the tree, 404 when empty
  POST     /relation-tuples/batch/expand     per-item trees or errors

Check bodies are ``{"allowed": bool}``; errors are herodot-shaped
``{"error": {"code", "status", "message"}}``.  An unknown namespace
answers ``allowed: false`` on a check (handler.go:169-171) and 404 on an
expand (the namespace lookup of ``Mapper.FromSubjectSet``).  Config
loading, the write API, gRPC, snaptokens, the result cache and deadlines
are not part of this server.
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
    SubjectSet,
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
EXPAND = "/relation-tuples/expand"
BATCH_EXPAND = "/relation-tuples/batch/expand"


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


def route(engine, method: str, path: str, query: Dict[str, str],
          body: bytes):
    """(status, json body) of one request."""
    if path in (EXPAND, BATCH_EXPAND):
        want = "GET" if path == EXPAND else "POST"
        if method != want:
            return 405, _error_body(405, f"method {method} not allowed")
        try:
            if path == EXPAND:
                return expand_route(engine, query)
            return batch_expand_route(engine, query, body)
        except KetoAPIError as e:
            return e.status_code, _error_body(e.status_code, e.message)
    return check_route(engine, method, path, query, body)


def _check_namespace(engine, subject: SubjectSet) -> None:
    """Raise the reference's 404 for a namespace the config lacks (the
    namespace lookup of ``Mapper.FromSubjectSet``)."""
    manager = getattr(engine, "namespace_manager", None)
    if manager is not None:
        manager.get_namespace(subject.namespace)


def expand_route(engine, query: Dict[str, str]):
    """GET /relation-tuples/expand: the subject set's tree, 404 "no
    relation tuple found" when it has no members."""
    subject = SubjectSet(
        namespace=query.get("namespace", ""),
        object=query.get("object", ""),
        relation=query.get("relation", ""),
    )
    _check_namespace(engine, subject)
    tree = engine.batch_expand([subject], _max_depth(query))[0]
    if tree is None:
        return 404, _error_body(404, "no relation tuple found")
    return 200, tree.to_json()


def batch_expand_route(engine, query: Dict[str, str], body: bytes):
    """POST /relation-tuples/batch/expand: ``{"subjects": [{namespace,
    object, relation}, ...], "max_depth"?}`` -> ``{"results": [...]}``,
    one ``{"tree": ...}`` or ``{"error", "status"}`` per item.  The items
    that pass their namespace check are expanded in one ``batch_expand``
    (each tree keeps its own visited set, so the trees are those of one
    call per item)."""
    try:
        data = json.loads(body.decode("utf-8") or "null")
    except (ValueError, UnicodeDecodeError) as e:
        raise BadRequestError(f"could not unmarshal json: {e}") from None
    if not isinstance(data, dict) or not isinstance(data.get("subjects"), list):
        raise BadRequestError('expected {"subjects": [...]}')
    depth = data.get("max_depth")
    try:
        depth = int(depth) if depth is not None else _max_depth(query)
    except (TypeError, ValueError) as e:
        # the JAX router answers what the handler's int() raised with 500
        return 500, _error_body(500, str(e))
    results: list = [None] * len(data["subjects"])
    todo = []
    for i, d in enumerate(data["subjects"]):
        if not isinstance(d, dict):
            results[i] = {"error": "subject must be an object", "status": 400}
            continue
        subject = SubjectSet(
            namespace=str(d.get("namespace", "")),
            object=str(d.get("object", "")),
            relation=str(d.get("relation", "")),
        )
        try:
            _check_namespace(engine, subject)
        except KetoAPIError as e:
            results[i] = {"error": str(e), "status": e.status_code or 500}
            continue
        todo.append((i, subject))
    trees = engine.batch_expand([s for _i, s in todo], depth) if todo else []
    for (i, _s), tree in zip(todo, trees):
        results[i] = ({"tree": tree.to_json()} if tree is not None else
                      {"error": "no relation tuple found", "status": 404})
    return 200, {"results": results}


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
    """An HTTP server answering the check and expand routes from ``engine``
    (anything with ``check_is_member(tuple, max_depth)`` and
    ``batch_expand(subjects, max_depth)``).  The caller runs
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
            status, payload = route(engine, method, parts.path, query, body)
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
