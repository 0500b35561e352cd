"""The port's reshard policy, reshard checkpoints, process topology and
gang liaison (``models/reshard.py``, ``utils/checkpoint.py``
``MeshShard`` / ``LazyLeaf``, ``parallel/multihost.py``,
``parallel/gang.py``) against the JAX package's, on the CPU, in process.

- ``plan_reshard`` / ``degraded_spec`` / ``carve_devices`` equal the
  JAX module's over every health mask of tp=2, tp=4 and ep2 x tp2, for
  the tiny dense and MoE configs, with and without a draft (the carved
  positions are the JAX plan's devices in the configured mesh's order).
- ``restore(shardings=mesh_shardings(...))`` of a tree saved whole, and
  the checkpoint ``ParamStore``'s lazy leaves placed by ``shard_tree``,
  are bit-equal to ``shard_tree`` of the whole tree at every rank of
  tp=2, tp=4 and ep2 x tp2; a checkpoint without its marker is refused.
- ``ProcessTopology``, ``gang_contract`` and ``initialize`` mirror the
  reference's; the liaison tests of ``tests/test_gang.py``'s
  ``TestGangLiaison`` run on the port's copy.
- The serve CLI's process-view checks exit as the reference's do.
"""

import itertools
import os
import socket
import time

import jax
import numpy as np
import pytest
import torch

from tpushare.models import moe as jm
from tpushare.models import reshard as jreshard
from tpushare.models import transformer as jt
from tpushare.parallel import make_mesh
from tpushare.parallel import multihost as jmultihost

from tpushare_torch.models import bridge, moe, reshard
from tpushare_torch.models import transformer as tt
from tpushare_torch.parallel import multihost
from tpushare_torch.parallel.gang import GangFollower, GangLeader
from tpushare_torch.parallel.mesh import ServingMesh
from tpushare_torch.parallel.sharding import shard_tree
from tpushare_torch.utils import checkpoint

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4,
    reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=4+")

TF_CFG = jt.tiny(remat=False)
MOE_CFG = jm.tiny(remat=False)
# A draft with one kv head: tp must then divide 1 as well.
DRAFT_CFG = jt.tiny(remat=False, n_kv_heads=1, n_heads=2)
MESHES = [({"tp": 2}, TF_CFG), ({"tp": 4}, TF_CFG),
          ({"tp": 2, "ep": 2}, MOE_CFG)]


def _port_cfg(cfg):
    return (bridge.moe_config_from_jax(cfg) if hasattr(cfg, "n_experts")
            else bridge.config_from_jax(cfg))


def _jax_plan(sizes, mask, cfg, draft):
    n = int(np.prod(list(sizes.values())))
    devices = jax.devices()[:n]
    mesh = make_mesh(sizes, devices=devices)
    conf = list(np.asarray(mesh.devices).flat)
    plan = jreshard.plan_reshard(mesh, np.array(mask), cfg, draft)
    picked = (None if plan.mesh is None else
              [conf.index(d) for d in np.asarray(plan.mesh.devices).flat])
    return plan.spec, plan.degraded, plan.n_healthy, picked


def _port_plan(sizes, mask, cfg, draft):
    n = int(np.prod(list(sizes.values())))
    mesh = ServingMesh(sizes, ["cpu"] * n)
    plan = reshard.plan_reshard(mesh, np.array(mask), _port_cfg(cfg),
                                None if draft is None else _port_cfg(draft))
    return plan.spec, plan.degraded, plan.n_healthy, plan.positions, plan


class TestPolicyParity:
    @pytest.mark.parametrize("sizes,cfg", MESHES,
                             ids=["tp2", "tp4", "ep2tp2"])
    @pytest.mark.parametrize("with_draft", [False, True])
    def test_every_health_mask(self, sizes, cfg, with_draft):
        n = int(np.prod(list(sizes.values())))
        draft = DRAFT_CFG if with_draft and "ep" not in sizes else None
        for mask in itertools.product([True, False], repeat=n):
            want = _jax_plan(sizes, mask, cfg, draft)
            *got, plan = _port_plan(sizes, mask, cfg, draft)
            assert tuple(got) == want, mask
            if plan.mesh is not None:
                assert plan.mesh.sizes["tp"] == plan.spec["tp"]
                assert plan.mesh.sizes["ep"] == plan.spec["ep"]
                assert plan.mesh.size == len(plan.positions)

    @pytest.mark.parametrize("n", range(0, 5))
    def test_degraded_spec(self, n):
        for conf, cfg in (({"tp": 4, "ep": 1}, TF_CFG),
                          ({"tp": 2, "ep": 2}, MOE_CFG)):
            for draft in (None, DRAFT_CFG):
                if draft is not None and hasattr(cfg, "n_experts"):
                    continue
                assert reshard.degraded_spec(
                    conf, n, _port_cfg(cfg),
                    None if draft is None else _port_cfg(draft)) == \
                    jreshard.degraded_spec(conf, n, cfg, draft)

    def test_carve_devices(self):
        for mask in itertools.product([True, False], repeat=4):
            for need in range(1, 5):
                assert reshard.carve_devices(list(range(4)), mask, need) \
                    == jreshard.carve_devices(list(range(4)),
                                              np.array(mask), need)

    def test_mesh_spec_of(self):
        assert reshard.mesh_spec_of(ServingMesh({"tp": 2, "ep": 2},
                                                ["cpu"] * 4)) == \
            jreshard.mesh_spec_of(make_mesh({"tp": 2, "ep": 2},
                                            devices=jax.devices()[:4]))


def _trees():
    g = torch.Generator().manual_seed(0)
    dense = tt.init_params(g, tt.tiny(), device="cpu")
    mcfg = moe.tiny()
    return [(dense, tt.param_specs(tt.tiny()), {"tp": 2}),
            (dense, tt.param_specs(tt.tiny()), {"tp": 4}),
            (moe.init_params(g, mcfg, device="cpu"), moe.param_specs(mcfg),
             {"tp": 2, "ep": 2})]


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


def _equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype and la[k].shape == lb[k].shape, k
        assert torch.equal(la[k], lb[k]), k


class TestReshardCheckpoints:
    @pytest.mark.parametrize("case", range(3), ids=["tp2", "tp4", "ep2tp2"])
    def test_restore_shardings_reads_each_ranks_slice(self, case,
                                                      tmp_path):
        tree, specs, sizes = _trees()[case]
        tree = dict(tree, step=torch.tensor(7))
        specs = dict(specs, step=None)
        path = str(tmp_path / "whole.safetensors")
        checkpoint.save(path, tree)
        n = int(np.prod(list(sizes.values())))
        for r in range(n):
            mesh = ServingMesh(sizes, ["cpu"] * n)
            mesh.rank = r
            want = shard_tree(tree, specs, mesh)
            got = checkpoint.restore(
                path, shardings=checkpoint.mesh_shardings(specs, mesh),
                device="cpu")
            _equal(got, want)
            # ``like`` holds the slices' shapes.
            got = checkpoint.restore(
                path, like=want, device="cpu",
                shardings=checkpoint.mesh_shardings(specs, mesh))
            _equal(got, want)

    @pytest.mark.parametrize("case", range(3), ids=["tp2", "tp4", "ep2tp2"])
    def test_param_store_sources_place_alike(self, case, tmp_path):
        tree, specs, sizes = _trees()[case]
        host = reshard.ParamStore(tree, draft_params=tree)
        disk = reshard.ParamStore(tree, path=str(tmp_path / "ck"))
        assert os.path.exists(str(tmp_path / "ck.meta.json"))
        hp, hd = host.load()
        dp, dd = disk.load()
        assert dd is None
        assert isinstance(dict(_leaves(dp))["embed"], checkpoint.LazyLeaf)
        n = int(np.prod(list(sizes.values())))
        for r in range(n):
            mesh = ServingMesh(sizes, ["cpu"] * n)
            mesh.rank = r
            want = shard_tree(tree, specs, mesh)
            _equal(shard_tree(hp, specs, mesh), want)
            _equal(shard_tree(hd, specs, mesh), want)
            _equal(shard_tree(dp, specs, mesh), want)

    def test_a_checkpoint_without_its_marker_is_refused(self, tmp_path):
        tree = _trees()[0][0]
        store = reshard.ParamStore(tree, path=str(tmp_path / "ck"))
        os.remove(str(tmp_path / "ck.meta.json"))
        with pytest.raises(RuntimeError, match="metadata marker"):
            store.load()
        from tpushare_torch.utils import atomicio
        atomicio.write_json(str(tmp_path / "ck.meta.json"),
                            {"complete": False})
        with pytest.raises(RuntimeError, match="incomplete"):
            store.load()

    def test_other_shardings_leaves_are_refused(self, tmp_path):
        path = str(tmp_path / "ck")
        checkpoint.save(path, {"w": torch.zeros(2)})
        with pytest.raises(NotImplementedError, match="MeshShard"):
            checkpoint.restore(path, shardings={"w": object()},
                               device="cpu")

    def test_host_mem_available_reads_meminfo(self):
        avail = reshard.host_mem_available()
        assert avail is None or avail > 0


class TestProcessTopology:
    def test_forced_view_partitions_contiguously(self):
        for n, size in ((2, 2), (2, 4), (4, 4)):
            got = multihost.ProcessTopology.forced_view(n, size)
            want = jmultihost.ProcessTopology.forced_view(n, size)
            assert (got.num_processes, got.process_index,
                    got.local_device_count, got.total_devices) == (
                want.num_processes, want.process_index,
                want.local_device_count, want.total_devices)
            for d in range(size):
                assert got.process_of(d) == want.process_of(d)
            for r in range(n):
                assert got.device_range(r) == want.device_range(r)

    def test_forced_view_requires_divisibility(self):
        with pytest.raises(ValueError, match="divide"):
            multihost.ProcessTopology.forced_view(3, 4)

    @pytest.mark.parametrize("kw", [
        {"num_processes": 0, "process_index": 0, "local_device_count": 1},
        {"num_processes": 2, "process_index": 2, "local_device_count": 1},
        {"num_processes": 2, "process_index": 0, "local_device_count": 0}])
    def test_ctor_validation(self, kw):
        with pytest.raises(ValueError):
            jmultihost.ProcessTopology(**kw)
        with pytest.raises(ValueError):
            multihost.ProcessTopology(**kw)

    def test_out_of_range_indices(self):
        topo = multihost.ProcessTopology.forced_view(2, 4)
        with pytest.raises(ValueError):
            topo.process_of(4)
        with pytest.raises(ValueError):
            topo.device_range(2)

    def test_gang_contract_and_initialize(self, monkeypatch):
        from tpushare_torch.plugin import const
        for k in (const.ENV_COORDINATOR, const.ENV_NUM_PROCESSES,
                  const.ENV_PROCESS_ID):
            monkeypatch.delenv(k, raising=False)
        assert multihost.gang_contract() is None
        assert jmultihost.gang_contract() is None
        assert multihost.initialize() is None
        monkeypatch.setenv(const.ENV_COORDINATOR, "10.0.0.1:8476")
        monkeypatch.setenv(const.ENV_NUM_PROCESSES, "2")
        monkeypatch.setenv(const.ENV_PROCESS_ID, "1")
        assert multihost.gang_contract() == jmultihost.gang_contract()
        assert multihost.initialize() == {
            "coordinator": "10.0.0.1:8476",
            "init_method": "tcp://10.0.0.1:8476", "num_processes": 2,
            "process_id": 1}
        monkeypatch.setenv(const.ENV_NUM_PROCESSES, "1")
        assert multihost.initialize() is None

    def test_process_tenant_mesh_is_dp_across_hosts(self, tmp_path):
        """dp across hosts, tp within each (``make_mesh`` elides tp at
        size 1), over a one-rank gloo group."""
        import torch.distributed as dist
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
            rank=0, world_size=1)
        try:
            mesh = multihost.process_tenant_mesh(1)
            assert mesh.mesh_dim_names == ("dp", "sp")
            assert tuple(mesh.shape) == (1, 1)
            with pytest.raises(ValueError, match="both groups"):
                multihost.hybrid_mesh({"dp": 1}, {"dp": 1})
        finally:
            dist.destroy_process_group()

    def test_addressable_fetch_is_one_host_copy(self):
        t = torch.arange(4)
        got = multihost.addressable_fetch({"a": [t, 3]})
        assert torch.equal(got["a"][0], t) and got["a"][1] == 3
        assert multihost.host_scalar(torch.tensor([5])) == 5


def _wait_until(cond, timeout_s=5.0, step_s=0.02):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step_s)
    return cond()


class TestGangLiaison:
    """``tests/test_gang.py``'s ``TestGangLiaison`` on the port's copy."""

    def test_heartbeat_registers_rank_and_fetch_counter(self):
        leader = GangLeader(2, heartbeat_timeout_s=1.0)
        follower = GangFollower(f"127.0.0.1:{leader.port}", 1,
                                interval_s=0.03, fetches_fn=lambda: 42)
        try:
            assert _wait_until(lambda: leader.seen_ranks() == [1])
            assert _wait_until(
                lambda: leader.process_fetches().get(1) == 42)
            assert leader.poll() == {"lost": [], "rejoined": []}
        finally:
            follower.stop()
            leader.close()

    def test_sever_ages_out_then_reconnect_rejoins(self):
        leader = GangLeader(2, heartbeat_timeout_s=0.25)
        follower = GangFollower(f"127.0.0.1:{leader.port}", 1,
                                interval_s=0.03)
        try:
            assert _wait_until(lambda: leader.seen_ranks() == [1])
            leader.sever(1)
            saw = {"lost": 0, "rejoined": 0}

            def pump():
                ev = leader.poll()
                saw["lost"] += ev["lost"].count(1)
                saw["rejoined"] += ev["rejoined"].count(1)
                return saw["rejoined"] >= 1

            assert _wait_until(pump, timeout_s=10.0, step_s=0.05)
            assert saw == {"lost": 1, "rejoined": 1}
        finally:
            follower.stop()
            leader.close()

    def test_never_seen_rank_is_not_lost(self):
        leader = GangLeader(3, heartbeat_timeout_s=0.05)
        try:
            time.sleep(0.15)
            assert leader.poll() == {"lost": [], "rejoined": []}
            assert leader.seen_ranks() == []
        finally:
            leader.close()

    def test_follower_backoff_survives_leader_arriving_late(self):
        probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        probe.bind(("127.0.0.1", 0))
        port = probe.getsockname()[1]
        probe.close()
        follower = GangFollower(f"127.0.0.1:{port}", 1, interval_s=0.03)
        try:
            time.sleep(0.1)
            leader = GangLeader(2, port=port, heartbeat_timeout_s=1.0)
            try:
                assert _wait_until(lambda: leader.seen_ranks() == [1])
            finally:
                leader.close()
        finally:
            follower.stop()

    def test_leader_requires_two_processes(self):
        with pytest.raises(ValueError, match="at least 2"):
            GangLeader(1)

    def test_malformed_beats_are_ignored(self):
        leader = GangLeader(2, heartbeat_timeout_s=1.0)
        try:
            with socket.create_connection(
                    ("127.0.0.1", leader.port), timeout=1.0) as s:
                s.sendall(b"not json\n{\"norank\": 1}\n"
                          b'{"rank": 1, "device_fetches": "x"}\n')
                assert _wait_until(lambda: leader.seen_ranks() == [1])
            assert leader.process_fetches() == {}
        finally:
            leader.close()


class TestEngineProcessValidation:
    """The reference's ``TestEngineProcessValidation`` on the port's
    engine (its refusals come before any server is placed)."""

    def _params(self):
        return (bridge.params_from_jax(
            jt.init_params(jax.random.PRNGKey(0), TF_CFG), device="cpu"),
            bridge.config_from_jax(TF_CFG))

    def test_num_processes_needs_a_mesh(self):
        from tpushare_torch.cli import serve as tserve
        params, cfg = self._params()
        with pytest.raises(ValueError, match="mesh feature"):
            tserve.ServeEngine(params, cfg, n_slots=2, n_blocks=16,
                               block_size=4, num_processes=2, device="cpu")

    def test_num_processes_must_divide_the_mesh(self):
        from tpushare_torch.cli import serve as tserve
        params, cfg = self._params()
        with pytest.raises(ValueError, match="divide"):
            tserve.ServeEngine(params, cfg, n_slots=2, n_blocks=16,
                               block_size=4, num_processes=3,
                               mesh=ServingMesh({"tp": 2}, ["cpu"] * 2),
                               device="cpu")

    def test_gang_needs_two_processes(self):
        from tpushare_torch.cli import serve as tserve
        params, cfg = self._params()
        with pytest.raises(ValueError, match="gang liaison"):
            tserve.ServeEngine(params, cfg, n_slots=2, n_blocks=16,
                               block_size=4, gang=object(),
                               mesh=ServingMesh({"tp": 2}, ["cpu"] * 2),
                               device="cpu")

    def test_host_event_needs_process_awareness(self):
        from tpushare_torch.cli import serve as tserve
        params, cfg = self._params()
        eng = tserve.ServeEngine(params, cfg, n_slots=2, n_blocks=16,
                                 block_size=4, device="cpu")
        with pytest.raises(ValueError, match="process-aware"):
            eng.host_event(1, False)
        eng.stop()


class TestCliProcessView:
    def _build(self, *argv):
        from tpushare_torch.cli import serve as tserve
        return tserve.build_engine(tserve.build_parser().parse_args(
            ["--device", "cpu", *argv]))

    def test_process_view_must_divide_the_mesh(self):
        with pytest.raises(SystemExit, match="divide"):
            self._build("--mesh", "tp=2", "--process-view", "3")

    def test_process_view_conflicts_with_gang_env(self, monkeypatch):
        from tpushare_torch.plugin import const
        monkeypatch.setenv(const.ENV_COORDINATOR, "127.0.0.1:8476")
        monkeypatch.setenv(const.ENV_NUM_PROCESSES, "2")
        monkeypatch.setenv(const.ENV_PROCESS_ID, "0")
        with pytest.raises(SystemExit, match="conflicts"):
            self._build("--mesh", "tp=2", "--process-view", "2")

    def test_the_jax_cli_exits_alike(self, monkeypatch):
        """Both daemons refuse a process view that does not divide the
        mesh with a message naming it."""
        from tpushare.cli import serve as jserve
        monkeypatch.setattr(jserve, "serve",
                            lambda *a, **kw: (_ for _ in ()).throw(
                                KeyboardInterrupt))
        import sys
        monkeypatch.setattr(sys, "argv", ["tpushare-serve", "--mesh",
                                          "tp=2", "--process-view", "3"])
        with pytest.raises(SystemExit, match="divide"):
            jserve.main()
