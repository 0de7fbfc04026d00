"""The port's read-port check and expand routes
(``ketotpu_torch.server.rest``) over a CPU engine: status codes and bodies
of the reference's check and expand surface, with the verdicts and trees
held against the JAX oracle's."""

import json
import threading
import urllib.error
import urllib.parse
import urllib.request

import pytest
import torch

from ketotpu.api.types import RelationTuple as JTuple
from ketotpu.api.types import SubjectSet as JSubjectSet
from ketotpu.engine.oracle import CheckEngine as JOracle
from ketotpu.engine.oracle import ExpandEngine as JExpand
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
EXPAND = "/relation-tuples/expand"
BATCH_EXPAND = "/relation-tuples/batch/expand"
EXPAND_ROOTS = ["Group:dev#members", "Group:admin#members", "Folder:keto#viewers",
                "Folder:root#viewers", "File:keto/README.md#parents",
                "File:private#owners", "File:keto/README.md#owners"]


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
    status, body = _call("GET", f"{base}/relation-tuples/nope")
    assert status == 404 and body["error"]["code"] == 404


def test_max_depth_limits_the_walk(served):
    base, oracle = served
    t = JTuple.from_string("File:keto/README.md#view@bob")
    for depth in (1, 2, 3, 5, 0x10):
        allowed = oracle.check_is_member(t, depth)
        q = urllib.parse.urlencode(dict(_query(t), **{"max-depth": str(depth)}))
        assert _call("GET", f"{base}{OPENAPI}?{q}") == (200, {"allowed": allowed})


@pytest.fixture(scope="module")
def expander():
    jstore = JStore()
    jstore.write_relation_tuples(*[JTuple.from_string(s) for s in REWRITES_TUPLES])
    return JExpand(jstore)


def _subject(s):
    head, rel = s.split("#", 1)
    ns, obj = head.split(":", 1)
    return {"namespace": ns, "object": obj, "relation": rel}


@pytest.mark.parametrize("root", EXPAND_ROOTS)
@pytest.mark.parametrize("depth", [None, "1", "2", "0x10"])
def test_expand_route_returns_the_oracle_tree(served, expander, root, depth):
    base, _ = served
    q = _subject(root)
    if depth is not None:
        q["max-depth"] = depth
    want = expander.build_tree(JSubjectSet(**_subject(root)),
                               int(depth, 0) if depth else 0)
    status, body = _call("GET", f"{base}{EXPAND}?{urllib.parse.urlencode(q)}")
    assert (status, body) == (200, want.to_json())


def test_expand_route_statuses(served):
    base, _ = served
    # a configured relation with no tuple: no tree
    q = urllib.parse.urlencode(_subject("File:keto/README.md#viewers"))
    assert _call("GET", f"{base}{EXPAND}?{q}") == (
        404, {"error": {"code": 404, "status": "Not Found",
                        "message": "no relation tuple found"}})
    # an unknown namespace: the namespace lookup's 404
    q = urllib.parse.urlencode(_subject("Unknown:x#view"))
    status, body = _call("GET", f"{base}{EXPAND}?{q}")
    assert status == 404 and body["error"]["message"] == (
        "namespace 'Unknown' was not found")
    # a malformed max-depth, and the wrong methods
    q = urllib.parse.urlencode(dict(_subject("Group:dev#members"),
                                    **{"max-depth": "deep"}))
    status, body = _call("GET", f"{base}{EXPAND}?{q}")
    assert status == 400 and "max-depth" in body["error"]["message"]
    assert _call("POST", f"{base}{EXPAND}", {})[0] == 405
    assert _call("GET", f"{base}{BATCH_EXPAND}")[0] == 405


def test_batch_expand_route_answers_per_item(served, expander):
    base, _ = served
    subjects = [_subject(r) for r in EXPAND_ROOTS] + [
        _subject("File:keto/README.md#viewers"), _subject("Unknown:x#view"),
        "not an object"]
    for body_depth, url in ((None, BATCH_EXPAND), (2, BATCH_EXPAND),
                            (None, BATCH_EXPAND + "?max-depth=1")):
        body = {"subjects": subjects}
        if body_depth is not None:
            body["max_depth"] = body_depth
        depth = body_depth if body_depth is not None else (
            1 if url.endswith("=1") else 0)
        status, got = _call("POST", f"{base}{url}", body)
        want = [{"tree": expander.build_tree(JSubjectSet(**_subject(r)),
                                             depth).to_json()}
                for r in EXPAND_ROOTS]
        want += [{"error": "no relation tuple found", "status": 404},
                 {"error": "namespace 'Unknown' was not found", "status": 404},
                 {"error": "subject must be an object", "status": 400}]
        assert (status, got) == (200, {"results": want})


def test_batch_expand_route_rejects_malformed_bodies(served):
    base, _ = served
    for body in (None, [], {"subjects": "x"}):
        status, got = _call("POST", f"{base}{BATCH_EXPAND}", body)
        assert status == 400 and got["error"]["message"] == (
            'expected {"subjects": [...]}')
    status, got = _call("POST", f"{base}{BATCH_EXPAND}",
                        {"subjects": [], "max_depth": "deep"})
    assert status == 500 and "deep" in got["error"]["message"]
