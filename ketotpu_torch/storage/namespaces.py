"""Namespace managers: static (in-config) and OPL-file backed.

Parity with the reference's three manager flavors
(`internal/driver/config/provider.go:315-342`): a literal namespace list, an
OPL file (re-parsed on change, keeping the previous value on parse errors,
`namespace_watcher.go:71-89`), and the lookup special cases of
`internal/namespace/definitions.go:37-62`.
"""

from __future__ import annotations

import hashlib
import os
import threading
from typing import Iterable, List, Optional, Protocol

from ketotpu_torch.api.types import BadRequestError, NotFoundError
from ketotpu_torch.opl.ast import Namespace, Relation
from ketotpu_torch.opl.parser import ParseError, parse


def namespaces_fingerprint(namespaces: Iterable[Namespace]) -> int:
    """Namespace-config identity: the AST reprs pin the content, so a
    reloaded config re-projects even when the tuple store did not move."""
    digest = hashlib.sha256()
    for ns in namespaces:
        digest.update(repr(ns).encode())
        digest.update(b"\x00")
    return int.from_bytes(digest.digest()[:8], "big", signed=True)


class NamespaceManager(Protocol):
    def get_namespace(self, name: str) -> Namespace: ...

    def namespaces(self) -> List[Namespace]: ...


class StaticNamespaceManager:
    """Fixed namespace list (config-literal flavor).  Entries without
    relations model legacy name-only namespaces."""

    def __init__(self, namespaces: Iterable[Namespace]):
        self._namespaces = list(namespaces)

    def get_namespace(self, name: str) -> Namespace:
        for n in self._namespaces:
            if n.name == name:
                return n
        raise NotFoundError(f"namespace {name!r} was not found")

    def namespaces(self) -> List[Namespace]:
        return list(self._namespaces)


class OPLFileNamespaceManager:
    """OPL-file-backed manager with mtime-based hot reload.

    On a failed re-parse the previous namespaces stay active (rollback
    semantics of the reference's OPL config watcher).
    """

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._namespaces: List[Namespace] = []
        self._mtime: Optional[float] = None
        self._last_errors: List[ParseError] = []
        try:
            self._mtime = os.stat(path).st_mtime
        except OSError:
            pass
        self._load(initial=True)

    def _load(self, *, initial: bool = False) -> None:
        with open(self.path, "r") as f:
            source = f.read()
        namespaces, errors = parse(source)
        if errors:
            self._last_errors = errors
            if initial:
                raise BadRequestError(
                    "parsing OPL file failed: "
                    + "; ".join(e.msg for e in errors)
                )
            return  # rollback: keep previous namespaces
        self._namespaces = namespaces
        self._last_errors = []

    def _maybe_reload(self) -> None:
        try:
            mtime = os.stat(self.path).st_mtime
        except OSError:
            return
        with self._lock:
            if self._mtime is None or mtime != self._mtime:
                try:
                    self._load()
                except OSError:
                    # Transient read failure (e.g. write-temp-then-rename
                    # window): keep previous namespaces, retry on next call.
                    return
                self._mtime = mtime

    def get_namespace(self, name: str) -> Namespace:
        self._maybe_reload()
        for n in self._namespaces:
            if n.name == name:
                return n
        raise NotFoundError(f"namespace {name!r} was not found")

    def namespaces(self) -> List[Namespace]:
        self._maybe_reload()
        return list(self._namespaces)


class DirectoryNamespaceManager:
    """Legacy namespace-directory watcher (`namespace_watcher.go:54`):
    one yaml/json/toml file per namespace (the pre-OPL config format,
    e.g. ``{"id": 0, "name": "videos"}`` — cat-videos-example shape),
    re-scanned on directory or file mtime change.  Files that fail to
    parse are skipped with rollback-to-previous semantics per file, like
    the reference's per-file watcher events; a failed parse still records
    the file's mtime so the broken content is not re-parsed until it
    changes (namespaces()/get_namespace() sit on the check hot path via
    the engine's config fingerprint)."""

    _EXTS = (".yml", ".yaml", ".json", ".toml")

    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()
        self._namespaces: dict = {}  # filename -> Namespace
        self._mtimes: dict = {}
        self._scan(initial=True)

    @staticmethod
    def _parse_file(fname: str):
        with open(fname, "rb") as f:
            raw = f.read()
        if fname.endswith(".json"):
            import json

            data = json.loads(raw)
        elif fname.endswith(".toml"):
            import tomllib

            data = tomllib.loads(raw.decode("utf-8"))
        else:
            import yaml

            data = yaml.safe_load(raw)
        if not isinstance(data, dict) or not data.get("name"):
            raise BadRequestError("namespace file must define 'name'")
        return Namespace(str(data["name"]))

    def _scan(self, *, initial: bool = False) -> None:
        try:
            entries = sorted(
                e for e in os.listdir(self.path)
                if e.endswith(self._EXTS)
            )
        except OSError as e:
            if initial:
                raise BadRequestError(
                    f"cannot read namespace directory {self.path!r}: {e}"
                ) from None
            return
        seen = set()
        for name in entries:
            fname = os.path.join(self.path, name)
            try:
                mtime = os.stat(fname).st_mtime
            except OSError:
                continue
            seen.add(name)
            if self._mtimes.get(name) == mtime:
                continue
            try:
                self._namespaces[name] = self._parse_file(fname)
            except Exception:  # noqa: BLE001 - per-file rollback
                pass  # keep the previous parse of this file, if any
            self._mtimes[name] = mtime
        for gone in set(self._mtimes) - seen:
            self._namespaces.pop(gone, None)
            del self._mtimes[gone]

    def get_namespace(self, name: str) -> Namespace:
        with self._lock:
            self._scan()
            for n in self._namespaces.values():
                if n.name == name:
                    return n
        raise NotFoundError(f"namespace {name!r} was not found")

    def namespaces(self) -> List[Namespace]:
        with self._lock:
            self._scan()
            return list(self._namespaces.values())


def ast_relation_for(
    manager: NamespaceManager, namespace: str, relation: str
) -> Optional[Relation]:
    """Look up the rewrite AST for (namespace, relation).

    Behavioral special cases (namespace/definitions.go:37-62):
    * empty relation -> None (not an error),
    * unknown namespace -> None ("not allowed", never "not found"),
    * namespace without relation config -> None,
    * known namespace that doesn't declare the relation -> BadRequest.
    """
    if relation == "":
        return None
    try:
        ns = manager.get_namespace(namespace)
    except Exception:
        return None
    if not ns.relations:
        return None
    rel = ns.relation(relation)
    if rel is not None:
        return rel
    raise BadRequestError(f"relation {relation!r} does not exist")
