"""The port's device-plugin half (``tpushare_torch/deviceplugin``,
``k8s``, ``plugin``) held to the JAX package's.

- Code: each verbatim copy's AST equals its original's once docstrings
  are dropped and ``tpushare_torch`` reads ``tpushare``; in the modules
  that change, every definition equals its original's but the ones a
  card changes (listed per module).
- ``const``: every name and value of the original, plus one name.
- Behaviour over the same ``FakeBackend`` node: equal topologies, equal
  fake-device lists, and the two Allocators' responses to the same
  requests, on the fast path and on every assumed-pod path, over the
  repo's fake kube client (the port's sees it through its own ``Pod``
  and ``ApiError``). The only difference allowed is the selection env
  (``TPU_*`` <-> ``NVIDIA_VISIBLE_DEVICES``) and the poison's spelling.
- ``NvmlBackend`` over a fake NVML (the C call surface, pointers written
  through ``.contents``) builds the topology ``build_topology_from_facts``
  builds from the same facts; without the library it is unavailable and
  ``auto_backend`` raises; ``ChainBackend`` flags NVML and torch facts
  that disagree.
"""

import ast
import copy
import ctypes
import json
import os

import pytest

from tpushare.deviceplugin import pb as jpb
from tpushare.k8s import client as jclient
from tpushare.plugin import allocate as jallocate
from tpushare.plugin import backend as jbackend
from tpushare.plugin import const as jconst
from tpushare.plugin import devices as jdevices
from tpushare.plugin import podmanager as jpodmanager

from tpushare_torch.deviceplugin import pb as tpb
from tpushare_torch.k8s import client as tclient
from tpushare_torch.k8s import types as ttypes
from tpushare_torch.plugin import allocate as tallocate
from tpushare_torch.plugin import backend as tbackend
from tpushare_torch.plugin import const as tconst
from tpushare_torch.plugin import devices as tdevices
from tpushare_torch.plugin import nvmldisc
from tpushare_torch.plugin import podmanager as tpodmanager
from tpushare_torch.plugin import topology as ttopology

from tests.fakes import FakeKubeClient, make_node, make_pod, now_ns

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VERBATIM = ["deviceplugin/__init__.py", "deviceplugin/api_pb2.py",
            "deviceplugin/rpc.py", "k8s/__init__.py", "k8s/types.py",
            "k8s/client.py", "k8s/events.py", "k8s/kubelet.py",
            "plugin/metrics.py", "plugin/podutils.py",
            "plugin/podmanager.py", "plugin/devices.py"]


def _strip_docstrings(tree):
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
    return tree


def _dump(node):
    return ast.dump(node).replace("tpushare_torch", "tpushare")


def _module(rel, pkg):
    path = os.path.join(ROOT, pkg, rel)
    return _strip_docstrings(ast.parse(open(path).read()))


def _defs(rel, pkg, cls=None):
    """name -> dumped AST of each top-level function and class (of the
    methods of ``cls`` when given)."""
    body = _module(rel, pkg).body
    if cls is not None:
        body = next(n for n in body
                    if isinstance(n, ast.ClassDef) and n.name == cls).body
    return {n.name: _dump(n) for n in body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("rel", VERBATIM)
def test_verbatim_copy_equals_original(rel):
    assert _dump(_module(rel, "tpushare_torch")) == \
        _dump(_module(rel, "tpushare"))


@pytest.mark.parametrize("rel,cls,gone,new", [
    # The env half: NVIDIA_VISIBLE_DEVICES in place of the TPU_* env
    # and its bounds.
    ("plugin/topology.py", None,
     {"tpu_env_for_chips"}, {"gpu_env_for_cards"}),
    # Three methods change (the selector, the poison, the stale check's
    # import of the extender's accounting); the class itself is not
    # compared whole.
    ("plugin/allocate.py", "Allocator", set(), set()),
    # TPU discovery gives way to NVML's and torch's.
    ("plugin/backend.py", None,
     {"SysfsBackend", "MetadataBackend", "JaxBackend", "_dev_index",
      "_generation_from_sysfs", "_host_id"},
     {"TorchBackend", "generation_from_name"}),
    ("utils/tenant.py", "HbmGuard", set(), set()),
    ("utils/tenant.py", None, set(),
     {"_indices", "mirror_visible_cards", "_apply_fraction",
      "tenant_device"}),
])
def test_changed_modules_keep_every_other_definition(rel, cls, gone, new):
    changed = {
        ("plugin/allocate.py", "Allocator"): {
            "_err_response", "_container_responses",
            "_stale_assume_conflicts"},
        ("plugin/backend.py", None): {
            "_build_topology", "build_topology_from_facts", "ChainBackend",
            "auto_backend"},
        ("utils/tenant.py", "HbmGuard"): {"_used_bytes"},
        # kv_quota_env reads its env names bare, not from const.
        ("utils/tenant.py", None): {
            "read_tenant_env", "apply_tenant_limits", "HbmGuard",
            "kv_quota_env"},
    }.get((rel, cls), set())
    t, j = _defs(rel, "tpushare_torch", cls), _defs(rel, "tpushare", cls)
    assert set(j) - set(t) == gone
    assert set(t) - set(j) == new
    assert {n for n in set(t) & set(j) if t[n] != j[n]} == changed


def test_backend_changes_are_the_cards_own():
    """Chip, HostTopology and FakeBackend differ from the originals only
    in comments and docstrings; ``_build_topology`` gains ``uuids``."""
    t = _defs("plugin/backend.py", "tpushare_torch")
    j = _defs("plugin/backend.py", "tpushare")
    for name in ("Chip", "HostTopology", "FakeBackend", "_mesh_coords",
                 "_default_mesh", "_read_int", "topology_to_json",
                 "Backend"):
        assert t[name] == j[name], name


def test_tenant_guard_keeps_the_original_machinery():
    """SoftHbmOom, the handler, the guard's loop, start and stop are the
    original's; only what the guard reads changes."""
    t = _defs("utils/tenant.py", "tpushare_torch", "HbmGuard")
    j = _defs("utils/tenant.py", "tpushare", "HbmGuard")
    assert {n for n in t if t[n] != j[n]} == {"_used_bytes"}
    t = _defs("utils/tenant.py", "tpushare_torch")
    j = _defs("utils/tenant.py", "tpushare")
    for name in ("_install_soft_oom_handler", "get_enforcing_guard",
                 "_int_env", "TenantSpec",
                 "AllocationError", "SoftHbmOom"):
        assert t[name] == j[name], name


@pytest.mark.parametrize("name,src", [
    ("pod_device_usage", "cli/inspect.py"),
    ("is_active_pod", "cli/inspect.py"),
    ("node_chip_count", "extender/core.py"),
    ("node_total_mem", "extender/core.py"),
    ("chip_free", "extender/core.py"),
])
def test_capacity_copies_equal_the_extenders(name, src):
    t = _defs("plugin/capacity.py", "tpushare_torch")
    j = _defs(src, "tpushare")
    assert t[name] == j[name]


def test_const_keeps_every_name_and_adds_the_card_selector():
    def names(m):
        return {k: v for k, v in vars(m).items()
                if not k.startswith("_") and not callable(v)}
    t, j = names(tconst), names(jconst)
    assert {k: t[k] for k in j} == j
    assert set(t) - set(j) == {"ENV_NVIDIA_VISIBLE_DEVICES"}
    assert tconst.ENV_NVIDIA_VISIBLE_DEVICES == "NVIDIA_VISIBLE_DEVICES"
    assert tconst.RESOURCE_NAME == "aliyun.com/tpu-mem"
    for u in ("GiB", "gi", "MiB", "m"):
        assert tconst.normalize_memory_unit(u) == \
            jconst.normalize_memory_unit(u)


FAKES = [dict(chips=1, hbm_gib=16), dict(chips=4, hbm_gib=16),
         dict(chips=8, hbm_gib=32, generation="v6e"),
         dict(chips=4, hbm_gib=16, unhealthy=[2]),
         dict(chips=2, hbm_gib=79.6, mesh=(2, 1, 1))]


@pytest.mark.parametrize("kw", FAKES)
def test_fake_node_topology_and_devices_equal(kw):
    tt = tbackend.FakeBackend(**kw).probe()
    jt = jbackend.FakeBackend(**kw).probe()
    assert tbackend.topology_to_json(tt) == jbackend.topology_to_json(jt)
    for unit in (tconst.GIB, tconst.MIB):
        if unit == tconst.MIB and kw["hbm_gib"] > 16:
            continue
        td, jd = tdevices.expand_devices(tt, unit), \
            jdevices.expand_devices(jt, unit)
        assert list(td.devices) == list(jd.devices)
        assert (td.uuid_to_index, td.units_per_chip, td.memory_unit) == \
            (jd.uuid_to_index, jd.units_per_chip, jd.memory_unit)


# -- the two Allocators over one fake apiserver ------------------------------

class PortKube:
    """A FakeKubeClient as the port's client reads it: the port's Pod
    and Node views, the port's ApiError."""

    def __init__(self, fake):
        self.fake = fake

    @staticmethod
    def _view(x):
        if isinstance(x, list):
            return [PortKube._view(v) for v in x]
        if type(x).__name__ in ("Pod", "Node"):
            return getattr(ttypes, type(x).__name__)(x.obj)
        return x

    def __getattr__(self, name):
        fn = getattr(self.fake, name)

        def call(*a, **kw):
            try:
                return self._view(fn(*a, **kw))
            except jclient.ApiError as e:
                raise tclient.ApiError(e.status_code, e.message,
                                       e.reason) from e
        return call


STALE_NS = int(400e9)          # past the 300 s default assume TTL


def _scenarios():
    t = now_ns()
    old = t - STALE_NS
    gang = {jconst.ANN_GANG_NAME: "g", jconst.ANN_GANG_SIZE: "2",
            jconst.ANN_GANG_RANK: "1",
            jconst.ANN_GANG_COORDINATOR: "10.0.0.1:8476"}

    def conflicts(n):
        def tweak(fake):
            fake.conflict_next_patches = n
        return tweak

    def list_fails_after(k):
        def tweak(fake):
            orig, calls = fake.list_pods, []

            def flaky(namespace=None, field_selector=None):
                calls.append(field_selector)
                if len(calls) > k:
                    raise jclient.ApiError(500, "injected")
                return orig(namespace=namespace,
                            field_selector=field_selector)
            fake.list_pods = flaky
        return tweak

    def racing_assume(fake):
        orig = fake.patch_pod

        def racing(ns, name, patch):
            out = orig(ns, name, patch)
            if ("default", "fresh") not in fake.pods:
                fake.pods[("default", "fresh")] = make_pod(
                    "fresh", mem=12, idx="0", assume_ns=t)
            return out
        fake.patch_pod = racing

    def candidate_list_fails(fake):
        fake.list_errors_remaining = 10

    return {
        "match": (4, [make_pod("p", mem=8, idx="2", assume_ns=t)], (8,), None),
        "multi_container": (4, [make_pod("p", mem=0, containers=[2, 3],
                                         idx="1", assume_ns=t)], (2, 3), None),
        "fifo": (4, [make_pod("younger", mem=4, idx="1", assume_ns=t + 1000),
                     make_pod("older", mem=4, idx="3", assume_ns=t)], (4,),
                 None),
        "no_match": (4, [], (4,), None),
        "wrong_size": (4, [make_pod("p", mem=6, idx="0", assume_ns=t)], (4,),
                       None),
        "missing_idx": (4, [make_pod("p", mem=4, assume_ns=t)], (4,), None),
        "idx_off_node": (2, [make_pod("p", mem=4, idx="7", assume_ns=t)],
                         (4,), None),
        "single_card_fast_path": (1, [], (4,), None),
        "single_card_assumed_off_node": (
            1, [make_pod("p", mem=8, idx="1", assume_ns=t)], (8,), None),
        "multi_card": (4, [make_pod("p", mem=64, idx="0,1,2,3",
                                    assume_ns=t)], (64,), None),
        "diagonal_cards": (4, [make_pod("p", mem=32, idx="0,3",
                                        assume_ns=t)], (32,), None),
        "conflict_retried": (4, [make_pod("p", mem=4, idx="0", assume_ns=t)],
                             (4,), conflicts(1)),
        "two_conflicts": (4, [make_pod("p", mem=4, idx="0", assume_ns=t)],
                          (4,), conflicts(2)),
        "legacy_gpu_dialect": (4, [make_pod("p", mem=4, idx="1",
                                            assume_ns=t, dialect="gpu")],
                               (4,), None),
        "candidate_list_fails": (4, [make_pod("p", mem=4, idx="0",
                                              assume_ns=t)], (4,),
                                 candidate_list_fails),
        "gang": (4, [make_pod("p", mem=8, idx="1", assume_ns=t,
                              annotations=gang)], (8,), None),
        "gang_partial": (4, [make_pod("p", mem=8, idx="1", assume_ns=t,
                                      annotations={jconst.ANN_GANG_NAME:
                                                   "g"})], (8,), None),
        "stale_skipped": (2, [make_pod("victim", mem=12, idx="0",
                                       assume_ns=old),
                              make_pod("fresh", mem=12, idx="0",
                                       assume_ns=t)], (12,), None),
        "stale_honored": (4, [make_pod("slow", mem=8, idx="1",
                                       assume_ns=old)], (8,), None),
        "stale_rejected": (2, [make_pod("victim", mem=12, idx="0",
                                        assume_ns=old),
                               make_pod("fresh", mem=12, idx="0",
                                        assume_ns=t, assigned="true",
                                        phase="Running")], (12,), None),
        "stale_multi_card": (2, [make_pod("victim", mem=32, idx="0,1",
                                          assume_ns=old),
                                 make_pod("small", mem=4, idx="0",
                                          assume_ns=t, assigned="true",
                                          phase="Running")], (32,), None),
        "stale_fails_open": (4, [make_pod("slow", mem=8, idx="1",
                                          assume_ns=old)], (8,),
                             list_fails_after(1)),
        "stale_regrant_unwound": (2, [make_pod("victim", mem=12, idx="0",
                                               assume_ns=old)], (12,),
                                  racing_assume),
    }


SCENARIOS = _scenarios()


def _run(pkg, chips, pods, sizes, tweak, disable_isolation):
    m = {"jax": (jbackend, jdevices, jpodmanager, jallocate, jpb),
         "port": (tbackend, tdevices, tpodmanager, tallocate, tpb)}[pkg]
    backend, devices, podmanager, allocate, pb = m
    topo = backend.FakeBackend(chips=chips, hbm_gib=16).probe()
    dm = devices.expand_devices(topo)
    fake = FakeKubeClient(nodes=[make_node(capacity={
        jconst.RESOURCE_NAME: chips * 16, jconst.RESOURCE_COUNT: chips})],
        pods=copy.deepcopy(pods))
    if tweak is not None:
        tweak(fake)
    kube = fake if pkg == "jax" else PortKube(fake)
    mgr = podmanager.PodManager(kube, "node-1", sleep=lambda s: None)
    alloc = allocate.Allocator(dm, topo, mgr, kube,
                               disable_isolation=disable_isolation)
    resp = alloc.allocate(pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devicesIDs=[f"d{i}-{j}"
                                                for j in range(n)])
        for i, n in enumerate(sizes)]))
    return resp, fake


def _normal(envs):
    """The selection env under one key, the poison in one spelling."""
    e = dict(envs)
    sel = e.pop(tconst.ENV_NVIDIA_VISIBLE_DEVICES, None)
    if sel is None:
        sel = e.pop(jconst.ENV_TPU_VISIBLE_CHIPS, None)
        for k in (jconst.ENV_TPU_VISIBLE_DEVICES, jconst.ENV_TPU_PROCESS_BOUNDS,
                  jconst.ENV_TPU_CHIPS_PER_PROCESS_BOUNDS):
            e.pop(k, None)
        if sel is not None:
            sel = sel.replace("no-tpu-has-", "no-gpu-has-")
    e["<selection>"] = sel
    return e


def _pods(fake):
    """The fake apiserver's pods, the assume time an ASSIGNED flip
    refreshes to the clock read as one token."""
    out = copy.deepcopy(fake.pods)
    for obj in out.values():
        ann = obj["metadata"].get("annotations", {})
        for flag, stamp in ((jconst.ANN_ASSIGNED_FLAG, jconst.ANN_ASSUME_TIME),
                            (jconst.LEGACY_ANN_ASSIGNED_FLAG,
                             jconst.LEGACY_ANN_ASSUME_TIME)):
            if ann.get(flag) == "true":
                ann[stamp] = "<flip time>"
    return out


@pytest.mark.parametrize("disable_isolation", [False, True])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_allocators_answer_alike(name, disable_isolation):
    chips, pods, sizes, tweak = SCENARIOS[name]
    jr, jf = _run("jax", chips, pods, sizes, tweak, disable_isolation)
    tr, tf = _run("port", chips, pods, sizes, tweak, disable_isolation)
    assert len(tr.container_responses) == len(jr.container_responses) \
        == len(sizes)
    for t, j in zip(tr.container_responses, jr.container_responses):
        assert not any(k.startswith("TPU_") for k in t.envs)
        assert _normal(t.envs) == _normal(j.envs)
        assert list(t.devices) == list(j.devices)
        sel = t.envs[tconst.ENV_NVIDIA_VISIBLE_DEVICES]
        assert sel.startswith("no-gpu-has-") or \
            sel == t.envs[tconst.ENV_RESOURCE_INDEX]
    assert _pods(tf) == _pods(jf)


def test_poison_names_the_request():
    tr, _ = _run("port", 4, [], (4,), None, False)
    envs = tr.container_responses[0].envs
    assert envs[tconst.ENV_NVIDIA_VISIBLE_DEVICES] == "no-gpu-has-4GiB-to-run"
    assert envs[tconst.ENV_RESOURCE_INDEX] == "-1"
    assert list(tr.container_responses[0].devices) == []


def test_gpu_env_for_cards():
    topo = tbackend.FakeBackend(chips=4).probe()
    assert ttopology.gpu_env_for_cards(topo, [2, 0]) == {
        "NVIDIA_VISIBLE_DEVICES": "0,2"}
    with pytest.raises(KeyError):
        ttopology.gpu_env_for_cards(topo, [5])


# -- NVML --------------------------------------------------------------------

class FakeNvml:
    """NVML's C call surface over fixed facts: count and memory through
    pointers (``.contents``), strings through their buffers (``.value``);
    a card whose ``bus`` is None answers the PCI call NOT_SUPPORTED."""

    def __init__(self, cards, init_rc=0):
        self.cards, self.init_rc, self.calls = cards, init_rc, []

    def nvmlInit_v2(self):
        self.calls.append("init")
        return self.init_rc

    def nvmlShutdown(self):
        self.calls.append("shutdown")
        return 0

    def nvmlErrorString(self, rc):
        return b"fake error"

    def nvmlDeviceGetCount_v2(self, n):
        n.contents.value = len(self.cards)
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, h):
        if i >= len(self.cards):
            return 2
        h.contents.value = i + 1
        return 0

    def _card(self, h):
        return self.cards[h.value - 1]

    def nvmlDeviceGetUUID(self, h, buf, n):
        buf.value = self._card(h)["uuid"].encode()
        return 0

    def nvmlDeviceGetName(self, h, buf, n):
        buf.value = self._card(h)["name"].encode()
        return 0

    def nvmlDeviceGetMemoryInfo(self, h, m):
        m.contents.total = self._card(h)["total"]
        m.contents.used = 1 << 20
        m.contents.free = m.contents.total - m.contents.used
        return 0

    def nvmlDeviceGetMinorNumber(self, h, n):
        n.contents.value = self._card(h)["minor"]
        return 0

    def nvmlDeviceGetPciInfo_v3(self, h, p):
        bus = self._card(h)["bus"]
        if bus is None:
            return 3
        p.contents.busId = bus.encode()
        return 0

    def nvmlDeviceGetComputeRunningProcesses_v3(self, h, n, arr):
        procs = self._card(h).get("procs", [])
        for i, (pid, used) in enumerate(procs):
            arr[i].pid, arr[i].usedGpuMemory = pid, used
        n.contents.value = len(procs)
        return 0


H100_TOTAL = 85520809984          # NVML's total on an H100 80GB HBM3


def _cards(n=4):
    return [{"uuid": f"GPU-{i:08x}-aaaa-bbbb-cccc-{i:012x}",
             "name": "NVIDIA H100 80GB HBM3", "total": H100_TOTAL,
             "minor": [1, 2, 4, 7][i % 4],
             "bus": None if i == 3 else f"00000000:{0x18 + i:02X}:00.0"}
            for i in range(n)]


@pytest.fixture
def host(tmp_path):
    """A fake /dev and PCI sysfs tree: card i's NUMA node is i // 2."""
    dev, pci = tmp_path / "dev", tmp_path / "pci"
    dev.mkdir()
    for name in ("nvidiactl", "nvidia-uvm"):
        (dev / name).touch()
    for i in range(3):
        d = pci / f"0000:{0x18 + i:02x}:00.0"
        d.mkdir(parents=True)
        (d / "numa_node").write_text(f"{i // 2}\n")
    return str(dev), str(pci)


def test_nvml_backend_builds_the_facts_topology(host):
    dev, pci = host
    fake = FakeNvml(_cards())
    topo = nvmldisc.NvmlBackend(lib=fake, dev_root=dev,
                                pci_root=pci).probe()
    want = tbackend.build_topology_from_facts(
        [0, 1, 2, 3], [0, 0, 1, 0], [H100_TOTAL] * 4,
        [c["uuid"] for c in _cards()], "h100",
        device_paths=[os.path.join(dev, f"nvidia{m}") for m in (1, 2, 4, 7)],
        shared_device_paths=[os.path.join(dev, "nvidiactl"),
                             os.path.join(dev, "nvidia-uvm")])
    assert topo == want
    assert fake.calls == ["init", "shutdown"]
    assert topo.mesh == (4, 1, 1)
    assert [c.coords for c in topo.chips] == [(i, 0, 0) for i in range(4)]
    assert {c.cores for c in topo.chips} == {1}
    # 79 GiB devices per card, their IDs carrying the card's UUID.
    dm = tdevices.expand_devices(topo)
    assert dm.units_per_chip == {i: 79 for i in range(4)}
    assert dm.devices[0].ID == f"{_cards()[0]['uuid']}-_-0"


def test_nvml_failed_call_raises_and_shuts_down():
    fake = FakeNvml(_cards(1))
    fake.nvmlDeviceGetUUID = lambda h, buf, n: 999
    with pytest.raises(nvmldisc.NvmlError, match="nvmlDeviceGetUUID"):
        nvmldisc.NvmlBackend(lib=fake).probe()
    assert fake.calls == ["init", "shutdown"]
    with pytest.raises(nvmldisc.NvmlError, match="nvmlInit_v2"):
        nvmldisc.NvmlBackend(lib=FakeNvml(_cards(1), init_rc=9)).probe()


def test_nvml_processes():
    cards = _cards(1)
    cards[0]["procs"] = [(1, 641728512), (7, 8963227648)]
    with nvmldisc.Nvml(FakeNvml(cards)) as nv:
        assert nv.processes(nv.handle(0)) == cards[0]["procs"]


def test_nvml_missing_means_unavailable_and_auto_backend_raises(monkeypatch):
    def missing(name=nvmldisc.LIBRARY):
        raise OSError(f"{name}: cannot open shared object file")
    monkeypatch.setattr(nvmldisc, "load_library", missing)
    monkeypatch.delenv("TPUSHARE_FAKE_CHIPS", raising=False)
    monkeypatch.delenv("TPUSHARE_BACKEND", raising=False)
    assert not nvmldisc.NvmlBackend().available()
    with pytest.raises(RuntimeError, match="no GPU discovery backend"):
        tbackend.auto_backend()
    monkeypatch.setenv("TPUSHARE_FAKE_CHIPS", "2")
    assert tbackend.auto_backend().name == "fake"
    assert tbackend.auto_backend("nvml").name == "nvml"
    chain = tbackend.auto_backend("torch")
    assert [b.name for b in chain.backends] == ["nvml", "torch"]
    with pytest.raises(ValueError):
        tbackend.auto_backend("sysfs")


def test_load_library_raises_without_nvml():
    with pytest.raises(OSError):
        nvmldisc.load_library("libnvidia-ml-absent.so.1")


def test_sysfs_pci_id():
    assert nvmldisc.sysfs_pci_id("00000000:18:00.0") == "0000:18:00.0"
    assert nvmldisc.sysfs_pci_id("00000001:AB:00.1") == "0001:ab:00.1"
    for bad in ("", "N/A", "zz:00.0"):
        assert nvmldisc.sysfs_pci_id(bad) is None


@pytest.mark.parametrize("name,gen", [
    ("NVIDIA H100 80GB HBM3", "h100"), ("NVIDIA A100-SXM4-80GB", "a100"),
    ("Tesla V100-SXM2-16GB", "v100"), ("NVIDIA GH200 480GB", "gh200"),
    ("NVIDIA GeForce RTX 4090", "nvidiageforcertx4090")])
def test_generation_from_name(name, gen):
    assert tbackend.generation_from_name(name) == gen


class TorchFacts(tbackend.Backend):
    """Torch's view of the fake NVML host, with ``total`` per card."""

    name = "torch"

    def __init__(self, totals, uuids=None):
        self.totals, self.uuids = totals, uuids

    def available(self):
        return True

    def probe(self):
        n = len(self.totals)
        return tbackend.build_topology_from_facts(
            list(range(n)), [0] * n, self.totals,
            self.uuids or [c["uuid"] for c in _cards(n)], "h100",
            device_paths=[""] * n)


@pytest.mark.parametrize("totals,uuids,flagged", [
    ([85017493504] * 2, None, None),            # the H100's 480 MiB reserve
    ([85017493504, 40 << 30], None, "card 1 memory"),
    ([H100_TOTAL + 1] * 2, None, "card 0 memory"),
    ([85017493504] * 2, ["GPU-x", "GPU-y"], "uuids"),
    ([85017493504], None, "chip_count"),
])
def test_chain_cross_checks_nvml_against_torch(totals, uuids, flagged):
    chain = tbackend.ChainBackend([
        nvmldisc.NvmlBackend(lib=FakeNvml(_cards(2))),
        TorchFacts(totals, uuids)])
    topo = chain.probe()
    assert topo.chips[0].hbm_bytes == H100_TOTAL      # NVML answered
    assert chain.checked_against == "torch"
    if flagged is None:
        assert chain.disagreement is None
    else:
        assert flagged in chain.disagreement


def test_chain_without_nvml_answers_from_torch_unchecked(monkeypatch):
    class Missing(nvmldisc.NvmlBackend):
        def available(self):
            return False
    chain = tbackend.ChainBackend([Missing(), TorchFacts([1 << 34])])
    assert chain.probe().chips[0].hbm_bytes == 1 << 34
    assert chain.checked_against is None and chain.disagreement is None


def test_topology_round_trips_through_the_node_annotation():
    topo = nvmldisc.NvmlBackend(lib=FakeNvml(_cards())).probe()
    back = ttopology.topology_from_annotation(
        ttopology.topology_annotation(topo))
    assert back.mesh == (4, 1, 1)
    assert ttopology.choose_submesh(back, 2) == [0, 1]
    assert ttopology.choose_submesh(back, 2, available=[1, 2, 3]) == [1, 2]
    assert json.loads(tbackend.topology_to_json(topo))["generation"] == "h100"


def test_pointer_arguments_match_the_declared_signatures():
    """The argument types ``load_library`` declares are the ones the
    typed layer passes (a ctypes mismatch would only show on the card)."""
    sig = nvmldisc._SIGNATURES
    assert sig["nvmlDeviceGetCount_v2"] == [ctypes.POINTER(ctypes.c_uint)]
    assert sig["nvmlDeviceGetMemoryInfo"][1] == \
        ctypes.POINTER(nvmldisc.NvmlMemory)
    assert ctypes.sizeof(nvmldisc.NvmlMemory) == 24
    assert ctypes.sizeof(nvmldisc.NvmlPciInfo) == 68
    assert ctypes.sizeof(nvmldisc.NvmlProcessInfo) == 24
