"""The port's read-port check routes (``ketotpu_torch.server.rest``) over a
CPU engine: status codes and bodies of the reference's check surface, with
the verdicts held against the JAX oracle."""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.opl.parser import parse as jparse
from ketotpu.storage import InMemoryTupleStore as JStore
from ketotpu.storage import StaticNamespaceManager as JManager
from ketotpu_torch.api.types import RelationTuple as TTuple
from ketotpu_torch.engine.device import DeviceCheckEngine
from ketotpu_torch.opl.parser import parse as tparse
from ketotpu_torch.server.rest import make_server
from ketotpu_torch.storage.memory import InMemoryTupleStore as TStore
from ketotpu_torch.storage.namespaces import StaticNamespaceManager as TManager
from torch_parity import FIXTURES, REWRITES_QUERIES, REWRITES_TUPLES

torch.set_num_threads(1)

CHECK = "/relation-tuples/check"
OPENAPI = "/relation-tuples/check/openapi"


@pytest.fixture(scope="module")
def served():
    src = (FIXTURES / "rewrites_namespaces.keto.ts").read_text()
    store = TStore()
    store.write_relation_tuples(*[TTuple.from_string(s) for s in REWRITES_TUPLES])
    engine = DeviceCheckEngine(store, TManager(tparse(src)[0]), device="cpu")
    jstore = JStore()
    jstore.write_relation_tuples(*[JTuple.from_string(s) for s in REWRITES_TUPLES])
    oracle = JOracle(jstore, JManager(jparse(src)[0]))
    server = make_server(engine, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield "http://%s:%d" % server.server_address[:2], oracle
    server.shutdown()
    server.server_close()
    thread.join()


def _call(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _query(t):
    return {"namespace": t.namespace, "object": t.object,
            "relation": t.relation, "subject_id": t.subject.id}


@pytest.mark.parametrize("query", [q for q in REWRITES_QUERIES
                                   if not q.startswith("Unknown")])
def test_statuses_and_bodies_follow_the_verdict(served, query):
    base, oracle = served
    t = JTuple.from_string(query)
    allowed = oracle.check_is_member(t)
    q = urllib.parse.urlencode(_query(t))
    for route, mirror in ((CHECK, True), (OPENAPI, False)):
        want = 403 if (mirror and not allowed) else 200
        assert _call("GET", f"{base}{route}?{q}") == (want, {"allowed": allowed})
        assert _call("POST", f"{base}{route}", _query(t)) == (
            want, {"allowed": allowed})


def test_unknown_namespace_is_denied_not_an_error(served):
    base, _ = served
    q = urllib.parse.urlencode(
        {"namespace": "Unknown", "object": "x", "relation": "view",
         "subject_id": "bob"})
    assert _call("GET", f"{base}{OPENAPI}?{q}") == (200, {"allowed": False})
    assert _call("GET", f"{base}{CHECK}?{q}") == (403, {"allowed": False})


def test_client_errors_are_herodot_shaped(served):
    base, _ = served
    # an undeclared relation of a configured namespace: the oracle's 400
    q = urllib.parse.urlencode({"namespace": "File", "object": "x",
                                "relation": "nope", "subject_id": "bob"})
    status, body = _call("GET", f"{base}{CHECK}?{q}")
    assert status == 400 and body["error"]["code"] == 400
    assert body["error"]["status"] == "Bad Request"
    # a missing subject
    q = urllib.parse.urlencode({"namespace": "File", "object": "x",
                                "relation": "view"})
    status, body = _call("GET", f"{base}{CHECK}?{q}")
    assert status == 400 and "subject" in body["error"]["message"]
    # a malformed max-depth
    q = urllib.parse.urlencode({"namespace": "File", "object": "x",
                                "relation": "view", "subject_id": "bob",
                                "max-depth": "deep"})
    status, body = _call("GET", f"{base}{CHECK}?{q}")
    assert status == 400 and "max-depth" in body["error"]["message"]
    # no such route
    status, body = _call("GET", f"{base}/relation-tuples/expand")
    assert status == 404 and body["error"]["code"] == 404


def test_max_depth_limits_the_walk(served):
    base, oracle = served
    t = JTuple.from_string("File:keto/README.md#view@bob")
    for depth in (1, 2, 3, 5, 0x10):
        allowed = oracle.check_is_member(t, depth)
        q = urllib.parse.urlencode(dict(_query(t), **{"max-depth": str(depth)}))
        assert _call("GET", f"{base}{OPENAPI}?{q}") == (200, {"allowed": allowed})
