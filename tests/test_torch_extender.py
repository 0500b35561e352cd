"""The port's scheduler extender and inspect CLI held to the JAX
package's.

- Code: the extender's copies by AST (``tpushare_torch`` read as
  ``tpushare``); ``extender/core.py`` and ``cli/inspect.py`` lose only
  the capacity functions they take from ``plugin/capacity.py``.
- Both packages' ``ExtenderService`` (``filter``, ``prioritize``,
  ``bind``) on the same hypothesis-drawn clusters (nodes x cards, pods
  with and without annotations, stale and finished ones, multi-card
  requests, spread policy, a gang): equal answers and equal pod
  annotations after every bind.
- Leader election over the fake apiserver: the same op sequences give
  the same verdicts and the same lease.
- ``PodCache`` against the JAX one over the same scripted watch streams.
- ``inspect``'s output byte for byte the JAX CLI's, with and without
  ``-d`` and for one node.
"""

import copy
import io
import json
import threading
import time
from http.server import ThreadingHTTPServer

import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tpushare.cli import inspect as jinspect
from tpushare.extender import leader as jleader
from tpushare.extender import server as jext
from tpushare.k8s import client as jclient
from tpushare.k8s import watch as jwatch
from tpushare.plugin import backend as jbackend
from tpushare.plugin import const as jconst
from tpushare.plugin import topology as jtopology

from tpushare_torch.cli import inspect as tinspect
from tpushare_torch.extender import leader as tleader
from tpushare_torch.extender import server as text
from tpushare_torch.k8s import client as tclient
from tpushare_torch.k8s import watch as twatch

from tests.fakes import FakeKubeClient, make_node, make_pod, now_ns
from tests.test_torch_plugin import PortKube, _defs, _dump, _module
from tests.test_watch import _State, _event, _handler, _wait

STALE_NS = int(400e9)          # past the 300 s default assume TTL


@pytest.mark.parametrize("rel", [
    "extender/__init__.py", "extender/__main__.py", "extender/leader.py",
    "extender/server.py"])
def test_extender_copy_equals_original(rel):
    """The console script's name reads tpushare-torch-* in the port."""
    assert _dump(_module(rel, "tpushare_torch")).replace(
        "tpushare-torch-", "tpushare-") == _dump(_module(rel, "tpushare"))


@pytest.mark.parametrize("rel,gone", [
    ("extender/core.py", {"chip_free", "node_chip_count", "node_total_mem"}),
    ("cli/inspect.py", {"pod_device_usage", "is_active_pod"}),
])
def test_changed_modules_lose_only_the_capacity_functions(rel, gone):
    t, j = _defs(rel, "tpushare_torch"), _defs(rel, "tpushare")
    assert set(j) - set(t) == gone
    assert set(t) - set(j) == set()
    assert {n for n in t if t[n] != j[n]} == set()


def test_the_capacity_functions_have_one_home():
    from tpushare_torch.extender import core
    from tpushare_torch.plugin import capacity
    for name in ("chip_free", "node_chip_count", "node_total_mem",
                 "is_active_pod"):
        assert getattr(core, name) is getattr(capacity, name)
    for name in ("pod_device_usage", "is_active_pod"):
        assert getattr(tinspect, name) is getattr(capacity, name)


# -- the clusters -------------------------------------------------------------------

@st.composite
def clusters(draw):
    """(nodes, existing pods, pending pods) of a drawn cluster."""
    t = now_ns()
    nodes, shapes = [], []
    for k in range(draw(st.integers(1, 3))):
        cards = draw(st.integers(1, 4))
        per = draw(st.sampled_from([4, 8, 16]))
        node = make_node(f"node-{k}", capacity={
            jconst.RESOURCE_NAME: cards * per,
            jconst.RESOURCE_COUNT: cards}, internal_ip=f"10.0.0.{k + 1}")
        if draw(st.booleans()):
            topo = jbackend.FakeBackend(chips=cards, hbm_gib=per).probe()
            node["metadata"]["annotations"] = {
                jconst.ANN_NODE_TOPOLOGY: jtopology.topology_annotation(topo)}
        nodes.append(node)
        shapes.append((cards, per))
    existing = []
    for i in range(draw(st.integers(0, 5))):
        k = draw(st.integers(0, len(nodes) - 1))
        cards, per = shapes[k]
        idx = draw(st.one_of(
            st.none(), st.integers(0, cards - 1).map(str),
            st.just(",".join(str(c) for c in range(min(cards, 2))))))
        existing.append(make_pod(
            f"e{i}", draw(st.integers(1, per)), node=f"node-{k}",
            idx=idx, assume_ns=t - draw(st.sampled_from([0, STALE_NS])),
            assigned=draw(st.sampled_from(["true", "false"])),
            phase=draw(st.sampled_from(["Running", "Pending",
                                        "Succeeded"]))))
    max_per = max(p for _, p in shapes)
    pending = []
    gang = draw(st.booleans())
    for i in range(draw(st.integers(1, 4))):
        ann = {}
        if draw(st.booleans()):
            ann[jconst.ANN_PLACEMENT_POLICY] = jconst.PLACEMENT_SPREAD
        if gang and i < 2:
            ann.update({jconst.ANN_GANG_NAME: "g", jconst.ANN_GANG_SIZE: "2"})
        pod = make_pod(f"p{i}", draw(st.integers(1, 2 * max_per)),
                       assigned=None, annotations=ann, node="")
        pending.append(pod)
    return nodes, existing, pending


def _services(nodes, pods):
    out = {}
    for pkg, ext in (("jax", jext), ("port", text)):
        fake = FakeKubeClient(nodes=copy.deepcopy(nodes),
                              pods=copy.deepcopy(pods))
        kube = fake if pkg == "jax" else PortKube(fake)
        out[pkg] = (ext.ExtenderService(kube), fake)
    return out


def _annotations(fake, bound):
    """Every pod's annotations and node, the assume time of the pods
    bound here read as one token (each package's bind takes its own
    clock reading)."""
    out = {}
    for key, obj in fake.pods.items():
        ann = dict(obj["metadata"].get("annotations", {}))
        if key[1] in bound:
            ann[jconst.ANN_ASSUME_TIME] = "<bind time>"
        out[key] = (ann, obj["spec"].get("nodeName"))
    return out


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(clusters())
def test_extenders_decide_alike(cluster):
    nodes, existing, pending = cluster
    svcs = _services(nodes, existing + pending)
    names = [n["metadata"]["name"] for n in nodes]
    bound = set()
    for pod in pending:
        got = {}
        for pkg, (svc, fake) in svcs.items():
            obj = copy.deepcopy(fake.pods[("default", pod["metadata"]
                                           ["name"])])
            by_name = svc.filter({"Pod": obj, "NodeNames": names})
            by_items = svc.filter({"Pod": obj, "Nodes": {
                "Items": [n for n in copy.deepcopy(nodes)]}})
            scores = svc.prioritize({"Pod": obj, "NodeNames": names})
            target = (by_name["NodeNames"] or names)[0]
            bind = svc.bind({"PodNamespace": "default",
                             "PodName": pod["metadata"]["name"],
                             "Node": target})
            got[pkg] = (by_name, by_items, scores, bind)
        assert got["port"] == got["jax"]
        if got["jax"][3]["Error"] == "":
            bound.add(pod["metadata"]["name"])
        assert _annotations(svcs["port"][1], bound) == \
            _annotations(svcs["jax"][1], bound)
    assert svcs["port"][1].bindings == svcs["jax"][1].bindings


# -- leader election ---------------------------------------------------------------

class Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


OPS = st.lists(st.one_of(
    st.tuples(st.just("tick"), st.sampled_from([1.0, 4.0, 16.0, 30.0])),
    st.tuples(st.just("try"), st.sampled_from(["a", "b", "c"])),
    st.tuples(st.just("stop"), st.sampled_from(["a", "b", "c"])),
    st.tuples(st.just("error"), st.integers(1, 2))), max_size=25)


def _election(pkg, ops):
    leader = jleader if pkg == "jax" else tleader
    fake, clock = FakeKubeClient(), Clock()
    kube = fake if pkg == "jax" else PortKube(fake)
    flips = []
    electors = {who: leader.LeaderElector(
        kube, who, namespace="kube-system", name="tpushare-extender",
        lease_duration_s=15, now=clock, sleep=lambda s: None,
        on_change=lambda v, who=who: flips.append((who, v)))
        for who in "abc"}
    seen = []
    for op, arg in ops:
        if op == "tick":
            clock.t += arg
        elif op == "try":
            seen.append(electors[arg].try_acquire_or_renew())
        elif op == "stop":
            electors[arg].stop()
        else:
            fake.lease_errors_remaining = arg
        seen.append({w: e.is_leader for w, e in electors.items()})
    return seen, flips, fake.leases


@settings(max_examples=60, deadline=None)
@given(OPS)
def test_leader_election_matches(ops):
    assert _election("port", ops) == _election("jax", ops)


def test_follower_refuses_bind():
    fake, clock = FakeKubeClient(), Clock()
    kube = PortKube(fake)
    mk = lambda who: tleader.LeaderElector(  # noqa: E731
        kube, who, namespace="kube-system", name="tpushare-extender",
        lease_duration_s=15, now=clock, sleep=lambda s: None)
    lead, follow = mk("a"), mk("b")
    assert lead.try_acquire_or_renew() and not follow.try_acquire_or_renew()
    out = text.ExtenderService(kube, elector=follow).bind(
        {"PodNamespace": "default", "PodName": "p", "Node": "n"})
    assert "not the lease holder" in out["Error"]
    out = text.ExtenderService(kube, elector=lead).bind(
        {"PodNamespace": "default", "PodName": "p", "Node": "n"})
    assert "not the lease holder" not in out["Error"]


# -- the pod cache -----------------------------------------------------------------

def _scripted(script, pods, faults):
    state = _State()
    state.pods = copy.deepcopy(pods)
    state.watch_script = copy.deepcopy(script)
    state.watch_faults = faults
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _handler(state))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd, state


@pytest.mark.parametrize("faults", [0, 2])
def test_pod_cache_matches(faults):
    a, b, c = make_pod("a", 4), make_pod("b", 8), make_pod("c", 2)
    pods = {("default", "a"): a, ("default", "c"): c}
    moved = copy.deepcopy(c)
    moved["metadata"]["annotations"][jconst.ANN_ASSIGNED_FLAG] = "true"
    script = [[_event("ADDED", b, 2), _event("DELETED", a, 3)],
              [_event("MODIFIED", moved, 4)]]
    got = {}
    for pkg, watch, client in (("jax", jwatch, jclient),
                               ("port", twatch, tclient)):
        httpd, state = _scripted(script, pods, faults)
        kube = client.KubeClient(client._Config(
            host="127.0.0.1", port=httpd.server_address[1], scheme="http"))
        cache = watch.PodCache(kube, watch_timeout_s=1,
                               error_backoff_s=0.05, sleep=time.sleep).start()
        try:
            assert _wait(lambda: not state.watch_script and
                         state.watch_calls >= len(script) + faults + 1)

            def view():
                return sorted((p.name, json.dumps(p.annotations,
                                                  sort_keys=True))
                              for p in cache.list())
            assert _wait(lambda: [n for n, _ in view()] == ["b", "c"])
            got[pkg] = (view(), cache.relists >= 1 + faults)
        finally:
            cache.stop()
            httpd.shutdown()
            httpd.server_close()
    assert got["port"] == got["jax"]
    assert got["port"][1]


# -- inspect ------------------------------------------------------------------------

def _inspect(pkg, fake, argv):
    mod = jinspect if pkg == "jax" else tinspect
    kube = fake if pkg == "jax" else PortKube(fake)
    out = io.StringIO()
    rc = mod.main(argv, kube=kube, out=out)
    return rc, out.getvalue()


def _hand_cluster():
    t = now_ns()
    gang = make_pod("w0", 32, idx="0,1", assume_ns=t, assigned="true",
                    phase="Running", annotations={
                        jconst.ANN_GANG_NAME: "trainer",
                        jconst.ANN_GANG_SIZE: "2", jconst.ANN_GANG_RANK: "0"})
    legacy = make_node("old", capacity={jconst.LEGACY_RESOURCE_NAME: "32",
                                        jconst.LEGACY_RESOURCE_COUNT: "2"})
    mib = make_node("mib", capacity={jconst.RESOURCE_NAME: str(4 * 16384),
                                     jconst.RESOURCE_COUNT: "4"},
                    internal_ip="10.0.0.9")
    nodes = [make_node("node-1", capacity={jconst.RESOURCE_NAME: "64",
                                           jconst.RESOURCE_COUNT: "4"},
                       internal_ip="10.0.0.1"), legacy, mib,
             make_node("plain")]
    pods = [make_pod("a", 4, idx="0", assume_ns=t, assigned="true",
                     phase="Running"),
            make_pod("stale", 8, idx="3", assume_ns=t - STALE_NS),
            make_pod("pending", 2, assume_ns=t),
            make_pod("done", 4, idx="1", assume_ns=t, phase="Succeeded"),
            make_pod("g", 6, idx="1", assume_ns=t, node="old",
                     dialect="gpu", resource=jconst.LEGACY_RESOURCE_NAME),
            make_pod("m", 4096, idx="2", assume_ns=t, node="mib"), gang]
    return nodes, pods


@pytest.mark.parametrize("argv", [[], ["-d"], ["node-1"], ["-d", "old"],
                                  ["-d", "missing"]])
def test_inspect_output_is_the_originals(argv):
    nodes, pods = _hand_cluster()
    fake = FakeKubeClient(nodes=nodes, pods=pods)
    j = _inspect("jax", fake, argv)
    assert _inspect("port", fake, argv) == j
    assert j[0] == (1 if "missing" in argv else 0)


def test_inspect_without_sharing_nodes():
    fake = FakeKubeClient(nodes=[make_node("plain")], pods=[])
    assert _inspect("port", fake, []) == _inspect("jax", fake, [])


@settings(max_examples=30, deadline=None)
@given(clusters())
def test_inspect_matches_on_drawn_clusters(cluster):
    nodes, existing, pending = cluster
    fake = FakeKubeClient(nodes=nodes, pods=existing + pending)
    for argv in ([], ["-d"]):
        assert _inspect("port", fake, argv) == _inspect("jax", fake, argv)
