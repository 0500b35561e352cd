"""The port's device-plugin daemon held to the JAX package's: the gRPC
servicer, the manager, the daemon and the card's health sources.

- Code: each copy's AST equals its original's once docstrings are
  dropped and ``tpushare_torch`` reads ``tpushare``; the changed modules
  list what they change (health: the card's sources; daemon: its flags'
  help; server: the health wiring; topology: the card's selector env).
- The two servicers on the same ``FakeBackend`` node, each on a real
  unix socket: ``GetDevicePluginOptions``, ``ListAndWatch``,
  ``GetPreferredAllocation``, ``Allocate`` and ``PreStartContainer``
  answer alike, the selection env and the poison's spelling apart.
- ``ErrorCounterMonitor`` (and the card's monitor over the same files)
  gives the JAX one's verdicts over hypothesis-drawn counter sequences.
- The XID source over a fake NVML with the event calls and a reference
  count: a critical XID -> unhealthy -> recovered; application XIDs not
  counted; ``NOT_SUPPORTED`` -> unavailable, said so, on the cards that
  gave it; a failed wait -> every card unhealthy until it stops; a
  discovery probe's shutdown keeps the event set. AER counters by PCI
  bus id.
- The manager re-registers when ``kubelet.sock`` is recreated.
- ``tests/test_daemon_e2e.py``'s three daemon-subprocess tests, driven
  against ``python -m tpushare_torch.plugin.daemon``; and the daemon
  with neither a fake nor NVML waits and logs, advertising nothing.
"""

import copy
import ctypes
import http.client
import logging
import os
import signal
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import grpc
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from tpushare import deviceplugin as jdp
from tpushare.plugin import backend as jbackend
from tpushare.plugin import const as jconst
from tpushare.plugin import health as jhealth
from tpushare.plugin import server as jserver
from tpushare.plugin import topology as jtopology

from tpushare_torch import deviceplugin as tdp
from tpushare_torch.plugin import backend as tbackend
from tpushare_torch.plugin import const as tconst
from tpushare_torch.plugin import health as thealth
from tpushare_torch.plugin import manager as tmanager
from tpushare_torch.plugin import nvmldisc
from tpushare_torch.plugin import server as tserver
from tpushare_torch.plugin import topology as ttopology

from tests.fakes import FakeKubeClient, make_node, make_pod, now_ns
from tests.test_daemon_e2e import (FakeApiserver, _free_port, _gang_pod,
                                   _start_kubelet_sim, _wait_registered,
                                   _write_kubeconfig)
from tests.test_server import KubeletSim
from tests.test_torch_plugin import (FakeNvml, PortKube, _cards, _defs,
                                     _dump, _module, _normal, _pods)

REPO = str(Path(__file__).parent.parent)
PROC_TIMEOUT_S = 60


# -- the code ------------------------------------------------------------------

@pytest.mark.parametrize("rel", [
    "plugin/coredump.py", "plugin/watchers.py", "plugin/manager.py",
    "k8s/watch.py", "cli/podgetter.py"])
def test_daemon_copy_equals_original(rel):
    assert _dump(_module(rel, "tpushare_torch")) == \
        _dump(_module(rel, "tpushare"))


@pytest.mark.parametrize("rel,gone,new,changed", [
    # The card's sources beside the copied monitor and hooks.
    ("plugin/health.py", set(),
     {"XidEvents", "CardErrorMonitor", "card_monitor"}, set()),
    # --backend's names and --device-nodes' help.
    ("plugin/daemon.py", set(), set(), {"build_arg_parser"}),
    # health_check wires the card's monitor.
    ("plugin/server.py", set(), set(), {"new_tpu_device_plugin"}),
    # The selector env; the three helpers the extender needs are back.
    ("plugin/topology.py", {"tpu_env_for_chips"}, {"gpu_env_for_cards"},
     set()),
])
def test_daemon_changed_modules_list_their_changes(rel, gone, new, changed):
    t, j = _defs(rel, "tpushare_torch"), _defs(rel, "tpushare")
    assert set(j) - set(t) == gone
    assert set(t) - set(j) == new
    assert {n for n in set(t) & set(j) if t[n] != j[n]} == changed


def test_health_module_constants():
    """The env names and the serve hooks' contract are the original's;
    no counter file is named by a card's index."""
    assert thealth.ENV_ERRFILES == jhealth.ENV_ERRFILES
    assert thealth.ENV_DRAIN_URL == jhealth.ENV_DRAIN_URL
    assert thealth.DEFAULT_ERRFILE_TEMPLATES == ()
    assert thealth.APPLICATION_XIDS == frozenset({13, 31, 43, 45, 68})
    assert thealth.AER_COUNTERS == ("aer_dev_fatal", "aer_dev_nonfatal")


@pytest.mark.parametrize("count", range(1, 17))
def test_topology_helpers_equal_the_originals(count):
    assert ttopology.default_mesh(count) == jtopology.default_mesh(count)
    t, j = ttopology.synthesize_topology(count), \
        jtopology.synthesize_topology(count)
    assert tbackend.topology_to_json(t) == jbackend.topology_to_json(j)
    idx = list(range(count))[::2] or [0]
    assert ttopology.submesh_dims(t, idx) == jtopology.submesh_dims(j, idx)


# -- the two servicers over one fake node -------------------------------------

def _scenario_pods():
    t = now_ns()
    return {
        "match": [make_pod("p", mem=8, idx="2", assume_ns=t)],
        "fifo": [make_pod("younger", mem=4, idx="1", assume_ns=t + 1000),
                 make_pod("older", mem=4, idx="3", assume_ns=t)],
        "no_match": [],
        "multi_card": [make_pod("p", mem=32, idx="0,1", assume_ns=t)],
    }


SERVICER_SCENARIOS = {"match": (8,), "fifo": (4,), "no_match": (4,),
                      "multi_card": (32,)}


def _servicer(pkg, tmp, pods):
    """(plugin, stub, channel, fake kube) of one package's servicer
    built by its new_tpu_device_plugin on a 4-card fake node."""
    be = (jbackend if pkg == "jax" else tbackend).FakeBackend(
        chips=4, hbm_gib=16)
    srv = jserver if pkg == "jax" else tserver
    fake = FakeKubeClient(nodes=[make_node(capacity={
        jconst.RESOURCE_NAME: 64, jconst.RESOURCE_COUNT: 4})],
        pods=copy.deepcopy(pods))
    kube = fake if pkg == "jax" else PortKube(fake)
    dpp = os.path.join(tmp, pkg)
    os.makedirs(dpp)
    plugin = srv.new_tpu_device_plugin(be, kube, "node-1",
                                       device_plugin_path=dpp)
    plugin.start()
    channel = srv.dial(plugin.socket_path)
    dp = jdp if pkg == "jax" else tdp
    return plugin, dp.DevicePluginStub(channel), channel, fake


@pytest.mark.parametrize("name", sorted(SERVICER_SCENARIOS))
def test_servicers_answer_alike(name, tmp_path):
    pods = _scenario_pods()[name]
    out = {}
    for pkg in ("jax", "port"):
        plugin, stub, channel, fake = _servicer(pkg, str(tmp_path), pods)
        pb = (jdp if pkg == "jax" else tdp).pb
        try:
            opts = stub.GetDevicePluginOptions(pb.Empty())
            stream = stub.ListAndWatch(pb.Empty())
            first = next(stream)
            stream.cancel()
            ids = [d.ID for d in first.devices]
            pref = stub.GetPreferredAllocation(
                pb.PreferredAllocationRequest(container_requests=[
                    pb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=ids[::3],
                        must_include_deviceIDs=ids[:1],
                        allocation_size=5),
                    pb.ContainerPreferredAllocationRequest(
                        available_deviceIDs=ids, allocation_size=20)]))
            alloc = stub.Allocate(pb.AllocateRequest(container_requests=[
                pb.ContainerAllocateRequest(devicesIDs=ids[:n])
                for n in SERVICER_SCENARIOS[name]]))
            pre = stub.PreStartContainer(pb.PreStartContainerRequest(
                devicesIDs=ids[:1]))
        finally:
            channel.close()
            plugin.stop()
        out[pkg] = {
            "opts": opts.SerializeToString(deterministic=True),
            "list": first.SerializeToString(deterministic=True),
            "pref": pref.SerializeToString(deterministic=True),
            "alloc": [(_normal(r.envs), [d.SerializeToString()
                                         for d in r.devices])
                      for r in alloc.container_responses],
            "pre": pre.SerializeToString(),
            "pods": _pods(fake),
            "node": fake.nodes["node-1"],
        }
        assert not os.path.exists(plugin.socket_path)
    assert out["port"] == out["jax"]
    assert len(out["port"]["alloc"]) == len(SERVICER_SCENARIOS[name])


# -- the error-counter monitor ---------------------------------------------------

@settings(max_examples=40, deadline=None)
@given(cards=st.integers(1, 3), recovery=st.integers(0, 4),
       polls=st.lists(st.lists(st.one_of(st.none(), st.integers(0, 6)),
                               min_size=3, max_size=3),
                      min_size=1, max_size=12))
def test_error_counter_monitors_agree(cards, recovery, polls):
    """The same counter files through the JAX monitor, the port's copy
    and the card's monitor (env-style templates, no NVML): the same
    verdicts poll by poll (None: the file is missing that poll)."""
    with tempfile.TemporaryDirectory() as tmp:
        tpl = os.path.join(tmp, "card{index}")
        mons = [jhealth.ErrorCounterMonitor([tpl], recovery),
                thealth.ErrorCounterMonitor([tpl], recovery),
                thealth.CardErrorMonitor(templates=[tpl],
                                         recovery_polls=recovery)]
        for values in polls:
            for i in range(cards):
                path = tpl.format(index=i)
                if values[i] is None:
                    if os.path.exists(path):
                        os.remove(path)
                else:
                    with open(path, "w") as f:
                        f.write(f"TOTAL_ERR_FATAL {values[i]}\n")
            got = [m.poll(range(cards)) for m in mons]
            assert got[1] == got[0] and got[2] == got[0]


def test_composite_prober_ands_discovery_and_the_cards_errors(tmp_path):
    be = tbackend.FakeBackend(chips=2)
    topo = be.probe()
    tpl = str(tmp_path / "card{index}")
    for i in range(2):
        (tmp_path / f"card{i}").write_text("0\n")
    prober = thealth.composite_prober(
        be, thealth.CardErrorMonitor(templates=[tpl], recovery_polls=1))
    assert all(prober(topo).values())
    (tmp_path / "card1").write_text("9\n")
    healthy = prober(topo)
    assert {c.index: healthy[c.uuid] for c in topo.chips} == {0: True,
                                                              1: False}


# -- the XID source ---------------------------------------------------------------

class EventNvml(FakeNvml):
    """FakeNvml with NVML's event calls and its reference-counted init:
    the last shutdown frees every event set (a wait on a freed set
    answers UNINITIALIZED). ``register_rc`` per card index; ``push``
    queues an XID for a card; a nonzero ``wait_rc`` fails every wait."""

    def __init__(self, cards, register_rc=None, supported=0xFF):
        super().__init__(cards)
        self.refs, self.sets, self.queue = 0, {}, []
        self.register_rc = register_rc or {}
        self.supported = supported
        self.wait_rc = 0

    def nvmlInit_v2(self):
        self.refs += 1
        return super().nvmlInit_v2()

    def nvmlShutdown(self):
        self.refs -= 1
        if self.refs == 0:
            self.sets.clear()
        return super().nvmlShutdown()

    def nvmlEventSetCreate(self, p):
        sid = len(self.sets) + 100
        self.sets[sid] = []
        p.contents.value = sid
        return 0

    def nvmlDeviceGetSupportedEventTypes(self, h, p):
        p.contents.value = self.supported
        return 0

    def nvmlDeviceRegisterEvents(self, h, types, s):
        rc = self.register_rc.get(h.value - 1, 0)
        if rc == 0:
            self.sets[s.value].append(h.value)
        return rc

    def push(self, index, xid, event_type=nvmldisc.EVENT_XID_CRITICAL):
        self.queue.append((index + 1, event_type, xid))

    def nvmlEventSetWait_v2(self, s, data, timeout_ms):
        if s.value not in self.sets:
            return 1                          # NVML_ERROR_UNINITIALIZED
        if self.wait_rc:
            return self.wait_rc
        if not self.queue:
            return nvmldisc.NVML_ERROR_TIMEOUT
        h, etype, xid = self.queue.pop(0)
        data.contents.device = h
        data.contents.eventType = etype
        data.contents.eventData = xid
        return 0

    def nvmlEventSetFree(self, s):
        self.sets.pop(s.value, None)
        return 0


def test_event_data_layout_and_signatures():
    assert ctypes.sizeof(nvmldisc.NvmlEventData) == 32
    sig = nvmldisc._SIGNATURES
    assert sig["nvmlEventSetWait_v2"] == [
        ctypes.c_void_p, ctypes.POINTER(nvmldisc.NvmlEventData),
        ctypes.c_uint]
    assert sig["nvmlDeviceRegisterEvents"][1] == ctypes.c_ulonglong
    assert nvmldisc.EVENT_XID_CRITICAL == 0x8
    assert nvmldisc.NVML_ERROR_TIMEOUT == 10


def test_critical_xid_is_unhealthy_then_recovers():
    fake = EventNvml(_cards(2))
    mon = thealth.CardErrorMonitor(fake, recovery_polls=2)
    assert mon.xid_status == "registered on 2 card(s)"
    assert mon.poll([0, 1]) == {0: True, 1: True}
    fake.push(1, 79)                          # fallen off the bus
    assert mon.poll([0, 1]) == {0: True, 1: False}
    assert mon.poll([0, 1]) == {0: True, 1: False}
    assert mon.poll([0, 1]) == {0: True, 1: True}
    assert mon.xid.seen == [(1, 79)]
    mon.close()
    assert fake.refs == 0 and not fake.sets


@pytest.mark.parametrize("xid", sorted(thealth.APPLICATION_XIDS))
def test_application_xids_are_not_counted(xid):
    fake = EventNvml(_cards(1))
    mon = thealth.CardErrorMonitor(fake, recovery_polls=1)
    fake.push(0, xid)
    fake.push(0, 48, event_type=0x4)          # not an XID event
    assert mon.poll([0]) == {0: True}
    assert mon.xid.ignored == [(0, xid)] and mon.xid.seen == []
    mon.close()


def test_registration_not_supported_is_reported_unavailable(caplog):
    fake = EventNvml(_cards(2), register_rc={
        0: nvmldisc.NVML_ERROR_NOT_SUPPORTED,
        1: nvmldisc.NVML_ERROR_NOT_SUPPORTED})
    with caplog.at_level(logging.WARNING, "tpushare.health"):
        mon = thealth.CardErrorMonitor(fake, recovery_polls=1)
    assert mon.xid_status.startswith(
        "unavailable: card 0: nvmlDeviceRegisterEvents")
    assert "NVML error 3" in mon.xid_status and "card 1: " in mon.xid_status
    assert "xid=unavailable" in mon.describe()
    assert any("XID source unavailable" in r.getMessage()
               for r in caplog.records)
    assert not mon.xid.available and not fake.sets and fake.refs == 0
    fake.push(0, 79)
    assert mon.poll([0, 1]) == {0: True, 1: True}


def test_one_cards_registration_failure_leaves_the_others(caplog):
    fake = EventNvml(_cards(2), register_rc={
        1: nvmldisc.NVML_ERROR_NOT_SUPPORTED})
    with caplog.at_level(logging.WARNING, "tpushare.health"):
        mon = thealth.CardErrorMonitor(fake, recovery_polls=1)
    assert mon.xid_status == (
        "registered on 1 card(s); unavailable on card 1: "
        "nvmlDeviceRegisterEvents failed: NVML error 3 (fake error)")
    assert any("XID source registered on 1 card(s); unavailable on card 1"
               in r.getMessage() for r in caplog.records)
    fake.push(0, 79)
    assert mon.poll([0, 1]) == {0: False, 1: True}
    assert mon.poll([0, 1]) == {0: True, 1: True}
    mon.close()
    assert fake.refs == 0 and not fake.sets


def test_no_xid_support_is_reported_unavailable():
    mon = thealth.CardErrorMonitor(EventNvml(_cards(1), supported=0x4))
    assert mon.xid_status == (
        "unavailable: card 0: nvmlDeviceGetSupportedEventTypes failed: "
        "NVML error 3 (no XID critical-error events)")


@pytest.mark.parametrize("rc", [15, 999])     # GPU_IS_LOST, UNKNOWN
def test_a_failed_wait_makes_every_card_unhealthy(rc, caplog):
    fake = EventNvml(_cards(2))
    mon = thealth.CardErrorMonitor(fake, recovery_polls=2)
    assert mon.poll([0, 1]) == {0: True, 1: True}
    fake.wait_rc = rc
    with caplog.at_level(logging.WARNING, "tpushare.health"):
        for _ in range(3):                    # for as long as it lasts
            assert mon.poll([0, 1]) == {0: False, 1: False}
    assert mon.xid.wait_errors == 3 and mon.xid.seen == []
    assert f"NVML error {rc}" in mon.xid.last_wait_error
    assert any("XID event wait failed" in r.getMessage()
               for r in caplog.records)
    fake.wait_rc = 0                          # then recovery_polls quiet
    assert mon.poll([0, 1]) == {0: False, 1: False}
    assert mon.poll([0, 1]) == {0: True, 1: True}
    mon.close()


def test_a_probes_shutdown_keeps_the_event_set(tmp_path):
    """NVML's init is reference-counted: the monitor's own init holds
    the set while the discovery probe opens and shuts its own."""
    fake = EventNvml(_cards(1))
    mon = thealth.CardErrorMonitor(fake, recovery_polls=1)
    assert fake.refs == 1
    nvmldisc.NvmlBackend(lib=fake).probe()    # init, ..., shutdown
    assert fake.refs == 1 and fake.sets
    fake.push(0, 48)
    assert mon.poll([0]) == {0: False}
    mon.close()
    # The planted fault: without the monitor's own init the probe's
    # shutdown frees the set; the XID is lost, and only the failed
    # wait's every-card bump is left.
    fake = EventNvml(_cards(1))
    xid = thealth.XidEvents(fake)
    xid._nv.__exit__(None, None, None)
    fake.push(0, 48)
    assert xid.drain() == {0}
    assert xid.seen == [] and xid.wait_errors == 1


def _pci_tree(tmp_path, cards):
    root = tmp_path / "pci"
    for c in cards:
        if c["bus"] is None:
            continue
        d = root / nvmldisc.sysfs_pci_id(c["bus"])
        d.mkdir(parents=True)
        for name in thealth.AER_COUNTERS:
            (d / name).write_text("BadTLP 0\nTOTAL_ERR_FATAL 0\n")
    return root


def test_aer_counters_by_pci_bus_id(tmp_path, caplog):
    cards = _cards(4)                         # card 3 has no bus id
    root = _pci_tree(tmp_path, cards)
    with caplog.at_level(logging.WARNING, "tpushare.health"):
        mon = thealth.CardErrorMonitor(EventNvml(cards), recovery_polls=1,
                                       pci_root=str(root))
    assert mon.aer_status == "6 file(s) on 3 card(s)"
    assert any("no AER counters for card(s) [3]" in r.getMessage()
               for r in caplog.records)
    assert mon.poll(range(4)) == {i: True for i in range(4)}
    fatal = root / nvmldisc.sysfs_pci_id(cards[2]["bus"]) / "aer_dev_fatal"
    fatal.write_text("BadTLP 0\nTOTAL_ERR_FATAL 1\n")
    assert mon.poll(range(4)) == {0: True, 1: True, 2: False, 3: True}
    assert mon.poll(range(4)) == {i: True for i in range(4)}
    mon.close()


def test_env_override_replaces_the_aer_defaults(tmp_path, monkeypatch):
    cards = _cards(1)
    root = _pci_tree(tmp_path, cards)
    monkeypatch.setenv("TPUSHARE_HEALTH_ERRFILES", str(tmp_path / "c{index}"))
    mon = thealth.CardErrorMonitor(EventNvml(cards), pci_root=str(root))
    assert mon.templates == [str(tmp_path / "c{index}")]
    assert mon.aer_status == "replaced by TPUSHARE_HEALTH_ERRFILES"
    assert mon.xid.available


def test_card_monitor_follows_the_backend(tmp_path):
    assert thealth.card_monitor(tbackend.FakeBackend(chips=1)).xid is None
    fake = EventNvml(_cards(1))
    nvml = nvmldisc.NvmlBackend(lib=fake, pci_root=str(tmp_path))
    mon = thealth.card_monitor(nvml)
    assert mon.xid.available and "aer=unavailable" in mon.describe()
    mon.close()
    mon = thealth.card_monitor(tbackend.ChainBackend(
        [nvmldisc.NvmlBackend(lib=fake), tbackend.FakeBackend(chips=1)]))
    assert mon.xid.available
    mon.close()


def test_health_check_logs_the_sources(tmp_path, caplog):
    fake = FakeKubeClient(nodes=[make_node()])
    with caplog.at_level(logging.INFO, "tpushare.server"):
        plugin = tserver.new_tpu_device_plugin(
            tbackend.FakeBackend(chips=1), PortKube(fake), "node-1",
            health_check=True, device_plugin_path=str(tmp_path))
    assert plugin._health_prober is not None
    assert any(r.getMessage().startswith(
        "health sources: counters=none; aer=unavailable: no NVML")
        for r in caplog.records)


# -- the manager -------------------------------------------------------------------

def test_manager_reregisters_when_kubelet_sock_is_recreated(tmp_path):
    dpp = str(tmp_path)
    kubelet = KubeletSim(dpp)
    kube = PortKube(FakeKubeClient(nodes=[make_node()]))
    mgr = tmanager.SharedTpuManager(
        kube, "node-1", backend=tbackend.FakeBackend(chips=2, hbm_gib=2),
        device_plugin_path=dpp, discovery_poll=0.01)
    done = threading.Event()

    def run():
        # Each idle iteration waits 0.4 s: enough to serve, see the
        # recreated socket and re-register, then return.
        mgr.run(max_iterations=15)
        done.set()

    threading.Thread(target=run, daemon=True).start()
    deadline = time.time() + 10
    while time.time() < deadline and not kubelet.registered:
        time.sleep(0.05)
    assert len(kubelet.registered) == 1
    assert kubelet.registered[0].resource_name == tconst.RESOURCE_NAME
    kubelet.stop()
    sock = os.path.join(dpp, "kubelet.sock")
    if os.path.exists(sock):
        os.remove(sock)
    kubelet2 = KubeletSim(dpp)
    try:
        while time.time() < deadline and not kubelet2.registered:
            time.sleep(0.05)
        assert len(kubelet2.registered) == 1
        assert done.wait(timeout=20)
        assert mgr.plugin is None or not os.path.exists(
            mgr.plugin.socket_path)
    finally:
        kubelet2.stop()


# -- the daemon as a process ----------------------------------------------------------

def _daemon(dpp, env, *extra):
    env = dict(os.environ, PYTHONPATH=REPO, **env)
    env.pop("TPUSHARE_BACKEND", None)
    return subprocess.Popen(
        [sys.executable, "-m", "tpushare_torch.plugin.daemon",
         "--device-plugin-path", str(dpp), "--token", "dummy", *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _end(proc):
    if proc.poll() is None:
        proc.kill()
    return proc.communicate(timeout=PROC_TIMEOUT_S)[0]


def test_daemon_subprocess_end_to_end(tmp_path):
    api = FakeApiserver()
    kubeconfig = _write_kubeconfig(tmp_path, api.server_address[1])
    dpp = tmp_path / "dpp"
    dpp.mkdir()
    registered = []
    server = _start_kubelet_sim(dpp, registered)
    metrics_port = _free_port()
    proc = _daemon(dpp, {"NODE_NAME": "node-1",
                         "KUBECONFIG": str(kubeconfig),
                         "TPUSHARE_FAKE_CHIPS": "2",
                         "TPUSHARE_FAKE_HBM_GIB": "16"},
                   "--backend", "fake", "--metrics-port", str(metrics_port))
    try:
        _wait_registered(proc, registered, timeout=PROC_TIMEOUT_S)
        assert registered[0].resource_name == "aliyun.com/tpu-mem"

        def get(path):
            conn = http.client.HTTPConnection("127.0.0.1", metrics_port,
                                              timeout=5)
            conn.request("GET", path)
            r = conn.getresponse()
            body = r.read().decode()
            conn.close()
            return r.status, body

        status, deadline = None, time.time() + PROC_TIMEOUT_S
        while time.time() < deadline:
            try:
                status, _ = get("/healthz")
                if status == 200:
                    break
            except OSError:
                pass
            time.sleep(0.2)
        assert status == 200
        _, metrics = get("/metrics")
        assert "tpushare_mem_units_advertised 32" in metrics
        assert "tpushare_chips_total 2" in metrics
        assert api.node["status"]["capacity"].get(
            "aliyun.com/tpu-count") in (2, "2")
        assert api.node["metadata"]["annotations"].get(
            "aliyun.com/tpu-topology")
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=PROC_TIMEOUT_S) == 0
    finally:
        _end(proc)
        server.stop(grace=0).wait()
        api.shutdown()
        api.server_close()


def test_two_daemons_inject_consistent_gang_contract(tmp_path):
    api = FakeApiserver(node_names=("node-1", "node-2"),
                        pods=[_gang_pod("w0", "node-1", 0),
                              _gang_pod("w1", "node-2", 1)])
    kubeconfig = _write_kubeconfig(tmp_path, api.server_address[1])
    daemons, servers = [], []
    try:
        for node in ("node-1", "node-2"):
            dpp = tmp_path / f"dpp-{node}"
            dpp.mkdir()
            registered = []
            servers.append(_start_kubelet_sim(dpp, registered))
            proc = _daemon(dpp, {"NODE_NAME": node,
                                 "KUBECONFIG": str(kubeconfig),
                                 "TPUSHARE_FAKE_CHIPS": "4",
                                 "TPUSHARE_FAKE_HBM_GIB": "16"},
                           "--backend", "fake")
            daemons.append((node, proc, dpp, registered))
        envs = {}
        for node, proc, dpp, registered in daemons:
            _wait_registered(proc, registered, node=node,
                             timeout=PROC_TIMEOUT_S)
            channel = grpc.insecure_channel(
                f"unix:{dpp}/{tconst.SERVER_SOCK_NAME}")
            resp = tdp.DevicePluginStub(channel).Allocate(
                tdp.pb.AllocateRequest(container_requests=[
                    tdp.pb.ContainerAllocateRequest(
                        devicesIDs=[f"d{j}" for j in range(64)])]))
            envs[node] = dict(resp.container_responses[0].envs)
            channel.close()
        for node in ("node-1", "node-2"):
            e = envs[node]
            assert e[tconst.ENV_NVIDIA_VISIBLE_DEVICES] == "0,1,2,3", e
            assert e[tconst.ENV_NUM_PROCESSES] == "2"
            assert e[tconst.ENV_COORDINATOR] == "10.0.0.1:8476"
        assert envs["node-1"][tconst.ENV_PROCESS_ID] == "0"
        assert envs["node-2"][tconst.ENV_PROCESS_ID] == "1"
        for p in api.pods:
            assert p["metadata"]["annotations"][
                tconst.ANN_ASSIGNED_FLAG] == "true", p["metadata"]["name"]
    finally:
        for _, proc, _, _ in daemons:
            _end(proc)
        for server in servers:
            server.stop(grace=0).wait()
        api.shutdown()
        api.server_close()


def test_binpack_manifest_e2e_real_daemon_and_extender(tmp_path):
    """demo/binpack-1 through the port's daemon and extender: pods from
    the manifest, /filter and /bind over HTTP, Allocate over the daemon's
    socket, the manifest's command as the tenant under the injected env,
    and a re-register when kubelet.sock is recreated."""
    from tpushare_torch.extender.server import make_server
    from tpushare_torch.k8s.client import KubeClient, _Config
    from tpushare_torch.tools.binpack import (binpack_pods, port_script)

    replicas, container, mem, script = binpack_pods()
    assert (replicas, mem) == (3, 2)
    api = FakeApiserver()
    for i in range(replicas):
        api.pods.append({
            "metadata": {"name": f"binpack-1-{i}", "namespace": "default",
                         "uid": f"uid-bp-{i}", "annotations": {}},
            "spec": {"nodeName": "", "containers": [
                {"name": container,
                 "resources": {"limits": {tconst.RESOURCE_NAME: mem}}}]},
            "status": {"phase": "Pending"}})
    kubeconfig = _write_kubeconfig(tmp_path, api.server_address[1])
    dpp = tmp_path / "dpp"
    dpp.mkdir()
    registered = []
    kubelet = _start_kubelet_sim(dpp, registered)
    proc = _daemon(dpp, {"NODE_NAME": "node-1",
                         "KUBECONFIG": str(kubeconfig),
                         "TPUSHARE_FAKE_CHIPS": "2",
                         "TPUSHARE_FAKE_HBM_GIB": "16"}, "--backend", "fake")
    ext = None
    try:
        _wait_registered(proc, registered, timeout=PROC_TIMEOUT_S)
        channel = grpc.insecure_channel(
            f"unix:{dpp}/{tconst.SERVER_SOCK_NAME}")
        stub = tdp.DevicePluginStub(channel)
        stream = stub.ListAndWatch(tdp.pb.Empty())
        devices = next(stream).devices
        stream.cancel()
        assert len(devices) == 32
        for key in ("capacity", "allocatable"):
            api.node["status"][key][tconst.RESOURCE_NAME] = len(devices)
        kube = KubeClient(_Config(host="127.0.0.1",
                                  port=api.server_address[1], scheme="http"))
        ext = make_server(kube, host="127.0.0.1", port=0)
        threading.Thread(target=ext.serve_forever, daemon=True).start()

        def post(path, obj):
            import json
            conn = http.client.HTTPConnection(
                "127.0.0.1", ext.server_address[1], timeout=30)
            conn.request("POST", path, json.dumps(obj))
            r = conn.getresponse()
            out = json.loads(r.read())
            conn.close()
            return out

        for i in range(replicas):
            name = f"binpack-1-{i}"
            pod_obj = next(p for p in api.pods
                           if p["metadata"]["name"] == name)
            out = post("/tpushare/filter",
                       {"Pod": pod_obj, "NodeNames": ["node-1"]})
            assert out["NodeNames"] == ["node-1"], out
            out = post("/tpushare/bind", {"PodNamespace": "default",
                                          "PodName": name, "Node": "node-1"})
            assert out["Error"] == "", out
        grants = []
        for i in range(replicas):
            resp = stub.Allocate(tdp.pb.AllocateRequest(container_requests=[
                tdp.pb.ContainerAllocateRequest(
                    devicesIDs=[f"bp{i}-{j}" for j in range(mem)])]))
            cr = resp.container_responses[0]
            envs = dict(cr.envs)
            assert not envs[tconst.ENV_NVIDIA_VISIBLE_DEVICES].startswith(
                "no-gpu"), envs
            grants.append((envs, list(cr.devices)))
        channel.close()
        assert len({e[tconst.ENV_RESOURCE_INDEX] for e, _ in grants}) == 1
        for envs, specs in grants:
            assert envs[tconst.ENV_HBM_LIMIT_BYTES] == str(2 << 30)
            assert any(s.host_path.startswith("/dev/") for s in specs)
        for p in api.pods:
            assert p["metadata"]["annotations"][
                tconst.ANN_ASSIGNED_FLAG] == "true", p["metadata"]["name"]
        out = subprocess.run(
            [sys.executable, "-c", port_script(script)],
            env=dict(os.environ, PYTHONPATH=REPO, **grants[0][0]),
            capture_output=True, text=True, timeout=PROC_TIMEOUT_S)
        assert out.returncode == 0, out.stderr
        card = grants[0][0][tconst.ENV_NVIDIA_VISIBLE_DEVICES]
        assert f"NVIDIA_VISIBLE_DEVICES: {card}" in out.stdout
        assert f"HBM limit: {2 << 30}" in out.stdout
        kubelet.stop(grace=0).wait()
        sock = dpp / "kubelet.sock"
        if sock.exists():
            sock.unlink()
        registered2 = []
        kubelet = _start_kubelet_sim(dpp, registered2)
        _wait_registered(proc, registered2, timeout=PROC_TIMEOUT_S)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=PROC_TIMEOUT_S) == 0
    finally:
        _end(proc)
        kubelet.stop(grace=0).wait()
        if ext is not None:
            ext.shutdown()
        api.shutdown()
        api.server_close()


def test_daemon_without_a_card_or_a_fake_waits_and_advertises_nothing(
        tmp_path):
    """No TPUSHARE_FAKE_CHIPS, no NVML on this host: the daemon logs
    that it found no device and waits; it never registers."""
    api = FakeApiserver()
    kubeconfig = _write_kubeconfig(tmp_path, api.server_address[1])
    dpp = tmp_path / "dpp"
    dpp.mkdir()
    registered = []
    server = _start_kubelet_sim(dpp, registered)
    env = dict(os.environ, PYTHONPATH=REPO, NODE_NAME="node-1",
               KUBECONFIG=str(kubeconfig))
    for k in ("TPUSHARE_FAKE_CHIPS", "TPUSHARE_BACKEND"):
        env.pop(k, None)
    log_path = tmp_path / "daemon.log"
    with open(log_path, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpushare_torch.plugin.daemon",
             "--device-plugin-path", str(dpp), "--token", "dummy"],
            cwd=REPO, env=env, stdout=out, stderr=subprocess.STDOUT)
    try:
        deadline = time.time() + PROC_TIMEOUT_S
        while time.time() < deadline and "waiting" not in \
                log_path.read_text():
            assert proc.poll() is None, log_path.read_text()
            time.sleep(0.2)
        time.sleep(1.0)               # past the probe: still nothing
        assert proc.poll() is None
        assert registered == []
        assert not (dpp / tconst.SERVER_SOCK_NAME).exists()
        assert api.node["status"]["capacity"] == {}
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait(timeout=PROC_TIMEOUT_S)
        server.stop(grace=0).wait()
        api.shutdown()
        api.server_close()
    log = log_path.read_text()
    assert "no TPU devices found" in log and "waiting" in log
    assert "no GPU discovery backend available" in log
