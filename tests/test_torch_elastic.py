"""The port's elastic sharded serving (ROADMAP A10b) against the JAX
package's, on the CPU in f32: degrade, replay and grow back across rank
processes, the process axis, the gang liaison and reshard checkpoints.

The port's engines run one process per rank (``tests/torch_spawn.py``
``elastic_worker``; every case on a fresh mesh bound as the serve CLI
binds it), the JAX package's on conftest's forced host devices. The same
weights (JAX ``init_params`` trees, bridged) and requests go through
both; the oracle is the JAX unsharded engine's greedy streams, which the
reference's elastic tests hold its own sharded engine to.

- The reference's ``TestElasticShrink``, ``TestChipEventIdempotent`` and
  ``TestMeshFaultClassification`` (``tests/test_sharded_serving.py``)
  and ``TestHostLossRecovery``, ``TestHostChaos``, ``TestGangEngine``,
  ``TestStatsProcessAxis``, ``TestMeshHostEndpoint``
  (``tests/test_multihost_serving.py``) on tp=2 (2 ranks) and ep=2 x
  tp=2 (4 ranks): streams across a shrink equal the JAX engine's, and
  the same counters, states and verdicts.
- A SIGKILLed rank process (the serve CLI's ``--process-view 2`` with
  the gang liaison) is resharded around within the heartbeat timeout +
  10 s, rejoins, and the engine grows back.
- The reshard policy (``models/reshard.py``) equals the JAX module's
  over every health mask of tp=2, tp=4 and ep2 x tp2, with and without
  a draft; the process topology and the gang contract equal the JAX
  ones; the CLI's process-view checks exit as the reference's do.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.cli import serve as jserve
from tpushare.models import moe as jm
from tpushare.models import transformer as jt

import torch_spawn
from tpushare_torch.cli import serve as tserve
from tpushare_torch.models import bridge
from tpushare_torch.parallel.gang import HEARTBEAT_TIMEOUT_S

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4,
    reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=4+")

TF_CFG = jt.tiny(remat=False)
TF_PARAMS = jt.init_params(jax.random.PRNGKey(0), TF_CFG)
MOE_CFG = jm.tiny(remat=False)
MOE_PARAMS = jm.init_params(jax.random.PRNGKey(0), MOE_CFG)
P = torch_spawn.ELASTIC_PROMPTS
SPAWN_TIMEOUT_S = 60.0

# The cases of each spawned run: (name, ServeEngine options).
CHIP_CASES = (
    ("shrink", {"prefill_chunk": 8}),
    ("spec_h2", {"speculative": True}),
    ("undrain", {}),
    ("checkpoint", {"reshard_checkpoint": "ckpt"}),
    ("budget0", {"max_reshards": 0}),
    ("total_loss", {}),
    ("idempotent", {"max_reshards": 3}),
    ("flap", {}),
    ("admit_death", {"max_replays": 3}),
    ("grow_fail", {}),
    ("chaos_no_process", {"chaos_spec": "host_loss:raise@p=1;seed=1"}))
HOST_CASES = (
    ("host_grow", {"num_processes": 2, "prefill_chunk": 8}),
    ("host_repeat", {"num_processes": 2}),
    ("host_budget0", {"num_processes": 2, "max_reshards": 0}),
    ("host_undrain", {"num_processes": 2}),
    ("host_chaos", {"num_processes": 2, "max_replays": 30,
                    "chaos_spec": "host_loss:raise@p=1;seed=1"}),
    ("process_stats", {"num_processes": 2}),
    ("gang", {"num_processes": 2, "gang": True}),
    ("host_route", {"num_processes": 2}))
EPTP_CASES = (
    ("shrink", {"prefill_chunk": 8}),
    ("host_grow", {"num_processes": 2}),
    ("non_serving", {}))


def _cfg_json(cfg):
    fields = dict(vars(cfg))
    fields.pop("dtype")
    return json.dumps(fields)


def _inputs(tmp):
    inp = {"tcfg": np.array(_cfg_json(bridge.config_from_jax(TF_CFG))),
           "mcfg": np.array(_cfg_json(bridge.moe_config_from_jax(MOE_CFG))),
           "out_dir": np.array(str(tmp))}
    for prefix, tree in (("tf/", TF_PARAMS), ("moe/", MOE_PARAMS)):
        inp.update(torch_spawn.flatten(jax.tree.map(np.asarray, tree),
                                       prefix))
    return inp


def _spawn(tmp, world, cases):
    out = torch_spawn.run_ranks(
        torch_spawn.elastic_worker, world, tmp, _inputs(tmp), list(cases),
        timeout=SPAWN_TIMEOUT_S, backend=None)
    return json.loads(str(out["res"]))


@pytest.fixture(scope="module")
def chip_run(tmp_path_factory):
    half = len(CHIP_CASES) // 2
    return {**_spawn(tmp_path_factory.mktemp("elastic_chip"), 2,
                     CHIP_CASES[:half]),
            **_spawn(tmp_path_factory.mktemp("elastic_chip2"), 2,
                     CHIP_CASES[half:])}


@pytest.fixture(scope="module")
def host_run(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("elastic_host"), 2, HOST_CASES)


@pytest.fixture(scope="module")
def eptp_run(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("elastic_eptp"), 4, EPTP_CASES)


def _oracle(prompts, max_tokens=6, moe=False, tf_params=TF_PARAMS):
    """The JAX unsharded engine's greedy streams (serial tick)."""
    kw = dict(n_slots=4, n_blocks=128, block_size=4, idle_sleep_s=0.0,
              overlap_tick=False, chaos_spec="")
    if moe:
        eng = jserve.ServeEngine(MOE_PARAMS, MOE_CFG, model_family="moe",
                                 kv="paged", **kw)
    else:
        eng = jserve.ServeEngine(tf_params, TF_CFG, **kw)
    reqs = [jserve._Request(list(p), max_tokens, None) for p in prompts]
    for r in reqs:
        assert eng.submit(r)
    for _ in range(800):
        if all(r.done.is_set() for r in reqs):
            break
        eng._loop_once()
    assert all(r.error is None for r in reqs)
    eng.stop()
    return [list(r.tokens) for r in reqs]


def _ok(run):
    assert run["errors"] == [None] * len(run["errors"]), run["errors"]
    return run["tokens"]


class TestElasticShrink:
    def test_dense_paged_tp2_to_1(self, chip_run):
        rec = chip_run["shrink"]
        assert _ok(rec["run"]) == _oracle(P)
        st = rec["shrunk"]
        assert st["reshards"] >= 1 and st["degraded"] is True
        assert st["replayed_on_reshard"] >= 1
        assert st["mesh_shape_current"] == {}
        assert st["mesh_shape_configured"] == {"tp": 2}
        assert st["reshard_ms"] is not None
        assert st["fetches_per_tick"] <= 1.0
        assert st["num_devices"] == 1 and st["num_devices_configured"] == 2

    def test_paged_moe_eptp_2x2_to_2x1(self, eptp_run):
        rec = eptp_run["shrink"]
        assert _ok(rec["run"]) == _oracle(P, moe=True)
        st = rec["shrunk"]
        assert st["reshards"] >= 1 and st["degraded"] is True
        # 2x1: ep survives the tie, tp collapses.
        assert st["mesh_shape_current"] == {"ep": 2}
        assert st["num_devices"] == 2

    def test_spec_horizon2_across_a_shrink(self, chip_run):
        rec = chip_run["spec_h2"]
        assert _ok(rec["run"]) == _oracle(P, max_tokens=16)
        assert rec["shrunk"]["reshards"] >= 1

    @pytest.mark.parametrize("which", ["chip_run", "eptp_run"])
    def test_grow_back_after_recovery(self, which, request):
        rec = request.getfixturevalue(which)["shrink"]
        st = rec["grown"]
        assert st["degraded"] is False and st["grow_backs"] == 1
        assert st["mesh_shape_current"] == st["mesh_shape_configured"]
        assert st["num_devices"] == st["num_devices_configured"]
        assert st["grow_back_ms"] is not None
        assert _ok(rec["again"]) == _oracle([[7, 7, 3]],
                                            moe=which == "eptp_run")

    def test_failed_grow_keeps_the_degraded_server_serving(self, chip_run):
        rec = chip_run["grow_fail"]
        assert _ok(rec["run"]) == _oracle(P)
        st = rec["failed_grow"]
        assert st["draining"] is False and st["degraded"] is True
        assert st["grow_backs"] == 0 and st["mesh_shape_current"] == {}
        assert st["last_error"].startswith("grow-back: mesh rebuild failed")
        assert _ok(rec["served"]) == _oracle([[5, 9, 12, 3]])
        assert rec["still"]["mesh_shape_current"] == {}
        # The grow is tried again at a later idle tick, and holds.
        assert rec["grown"]["grow_backs"] == 1
        assert rec["grown"]["mesh_shape_current"] == {"tp": 2}
        assert _ok(rec["again"]) == _oracle([[7, 7, 3]])

    def test_undrain_is_the_all_clear(self, chip_run):
        rec = chip_run["undrain"]
        assert rec["shrunk"]["degraded"] is True
        assert rec["end_drain"] is True
        assert rec["grown"]["degraded"] is False
        assert rec["grown"]["mesh_shape_current"] == {"tp": 2}

    def test_reshard_checkpoint_source(self, chip_run, tmp_path_factory):
        rec = chip_run["checkpoint"]
        assert _ok(rec["run"]) == _oracle([[5, 9, 12, 3], [9, 9, 2]])
        assert rec["shrunk"]["reshards"] == 1

    def test_reshard_checkpoint_requires_mesh(self):
        with pytest.raises(ValueError, match="mesh"):
            tserve.ServeEngine(
                bridge.params_from_jax(TF_PARAMS, device="cpu"),
                bridge.config_from_jax(TF_CFG), n_slots=2, n_blocks=32,
                block_size=4, device="cpu",
                reshard_checkpoint="/tmp/nope")

    def test_reshard_budget_exhausted_goes_drained_sticky(self, chip_run):
        rec = chip_run["budget0"]
        assert rec["st"]["reshards"] == 0
        assert rec["sticky"] == [True, True]
        assert "reshard budget exhausted" in rec["st"]["last_error"]
        assert rec["late_error"] is True
        assert rec["end_drain"] is False

    def test_total_chip_loss_drains_and_fails_fast(self, chip_run):
        rec = chip_run["total_loss"]
        assert rec["failed"] is True
        assert "no serving shape" in rec["st"]["last_error"]
        assert rec["sticky"] == [True, True]


class TestChipEventIdempotent:
    def test_repeated_unhealthy_events_do_not_burn_the_budget(self,
                                                              chip_run):
        rec = chip_run["idempotent"]
        assert rec["first"] == 1
        assert rec["st"]["reshards"] == 1
        assert rec["st"]["degraded"] is True
        assert rec["draining"] is False


class TestMeshFaultClassification:
    def test_admission_dispatch_death_reshards(self, chip_run):
        rec = chip_run["admit_death"]
        assert _ok(rec["run"]) == _oracle([[5, 9, 12, 3]], max_tokens=4)
        assert rec["st"]["reshards"] == 1
        assert rec["st"]["replays"] == 1

    def test_flap_before_the_tick_is_a_no_op(self, chip_run):
        rec = chip_run["flap"]
        assert rec["st"]["reshards"] == 0
        assert rec["st"]["quarantines"] == 0
        assert rec["st"]["degraded"] is False
        assert rec["fault"] is None

    def test_non_serving_chip_death_records_without_rebuild(self,
                                                            eptp_run):
        rec = eptp_run["non_serving"]
        assert rec["after_idle_death"]["reshards"] == 1
        assert rec["after_idle_death"]["degraded"] is True
        assert rec["partial_recovery_grow_backs"] == 0
        assert rec["full"]["grow_backs"] == 1
        assert rec["full"]["degraded"] is False


class TestHostLossRecovery:
    def test_host_kill_mid_stream_token_exact(self, host_run):
        rec = host_run["host_grow"]
        assert _ok(rec["run"]) == _oracle(P)
        st = rec["shrunk"]
        assert st["host_losses"] == 1 and st["reshards"] >= 1
        assert st["replayed_on_reshard"] >= 1

    def test_moe_eptp_host_kill_token_exact(self, eptp_run):
        rec = eptp_run["host_grow"]
        assert _ok(rec["run"]) == _oracle(P, moe=True)
        assert rec["shrunk"]["host_losses"] == 1
        assert rec["shrunk"]["reshards"] >= 1

    @pytest.mark.parametrize("which", ["host_run", "eptp_run"])
    def test_grow_back_after_host_rejoin(self, which, request):
        rec = request.getfixturevalue(which)["host_grow"]
        st = rec["grown"]
        assert st["host_rejoins"] == 1 and st["grow_backs"] >= 1
        assert st["mesh_shape_current"] == st["mesh_shape_configured"]
        assert st["healthy_processes"] == st["num_processes"] == 2
        assert st["degraded"] is False

    def test_repeated_loss_events_count_once(self, host_run):
        rec = host_run["host_repeat"]
        assert rec["losses"] == 1 and rec["rejoins"] == 1

    def test_budget_exhausted_goes_drained_sticky(self, host_run):
        rec = host_run["host_budget0"]
        assert rec["st"]["reshards"] == 0
        assert rec["sticky"] == [True, True]
        assert "reshard budget exhausted" in rec["st"]["last_error"]
        assert rec["end_drain"] is False

    def test_undrain_resets_host_health(self, host_run):
        rec = host_run["host_undrain"]
        assert rec["end_drain"] is True
        assert rec["st"]["healthy_processes"] == 2


class TestHostChaos:
    def test_host_loss_chaos_storm_token_exact(self, host_run):
        rec = host_run["host_chaos"]
        assert _ok(rec["run"]) == _oracle(P)
        st = rec["st"]
        assert st["host_losses"] >= 1 and st["reshards"] >= 1
        assert st["healthy_processes"] >= 1
        assert st["chaos_fired"].get("host.loss", 0) >= 1

    def test_single_process_engine_ignores_the_point(self, chip_run):
        rec = chip_run["chaos_no_process"]
        assert _ok(rec["run"]) == _oracle(P)
        assert rec["st"]["host_losses"] == 0
        assert rec["st"]["chaos_fired"].get("host.loss", 0) == 0


class TestGangEngine:
    def test_sever_to_reshard_to_rejoin_to_grow_back(self, host_run):
        rec = host_run["gang"]
        assert rec["seen"] == [1]
        assert _ok(rec["run"]) == _oracle(P, max_tokens=8)
        st = rec["st"]
        assert st["host_losses"] >= 1 and st["host_rejoins"] >= 1
        assert st["reshards"] >= 1 and st["grow_backs"] >= 1
        assert st["mesh_shape_current"] == st["mesh_shape_configured"]
        assert st["gang"]["process_fetches"].get("1") == 7
        assert st["gang"]["num_processes"] == 2


class TestStatsProcessAxis:
    def test_nulls_when_unsharded(self):
        eng = tserve.ServeEngine(
            bridge.params_from_jax(TF_PARAMS, device="cpu"),
            bridge.config_from_jax(TF_CFG), n_slots=2, n_blocks=32,
            block_size=4, device="cpu")
        st = eng.stats()
        assert st["num_processes"] is None
        assert st["process_index"] is None
        assert st["healthy_processes"] is None
        assert st["gang"] is None
        assert st["host_losses"] == 0 and st["host_rejoins"] == 0
        assert st["reshard_ms"] is None
        assert st["degraded"] is None
        eng.stop()

    def test_nulls_when_sharded_but_single_process(self, chip_run):
        st = chip_run["shrink"]["shrunk"]
        assert st["num_processes"] is None
        assert st["healthy_processes"] is None

    def test_process_fields_on_a_process_mesh(self, host_run):
        st = host_run["process_stats"]["st"]
        assert st["num_processes"] == 2
        assert st["process_index"] == 0
        assert st["healthy_processes"] == 2
        assert st["gang"] is None       # no liaison attached


class TestMeshHostEndpoint:
    def test_route_drives_the_host_ladder(self, host_run):
        codes = host_run["host_route"]["codes"]
        code, out = codes[0]
        assert code == 200 and out["rank"] == 1
        assert out["healthy_processes"] == 1 and out["num_processes"] == 2
        code, out = codes[1]
        assert code == 200 and out["healthy_processes"] == 2
        assert [c for c, _ in codes[2:]] == [400] * 5

    def test_route_400s_without_a_process_mesh(self):
        eng = tserve.ServeEngine(
            bridge.params_from_jax(TF_PARAMS, device="cpu"),
            bridge.config_from_jax(TF_CFG), n_slots=2, n_blocks=32,
            block_size=4, device="cpu")
        httpd = tserve.serve(eng, host="127.0.0.1", port=0, timeout_s=10.0)
        try:
            code, out = torch_spawn._post_json(
                httpd.server_address[1], "/mesh/host",
                {"rank": 0, "healthy": False})
            assert code == 400 and "process-aware" in out["error"]
        finally:
            httpd.shutdown()
            httpd.server_close()
            eng.stop()


def test_sigkilled_rank_is_resharded_around(tmp_path):
    """The serve CLI's two rank processes (``--process-view 2``, the
    gang liaison one port above ``--dist-init``): rank 1 SIGKILLed
    mid-wave is detected by the liaison, the engine reshards to tp=1
    within the heartbeat timeout + 10 s, every answer equals the JAX
    engine's, the restarted rank rejoins and the engine grows back."""
    from tpushare_torch.parallel.multihost_smoke import run_elastic
    env = dict(os.environ, OMP_NUM_THREADS="1")
    argv = ["--preset", "tiny", "--device", "cpu", "--n-slots", "4",
            "--n-blocks", "128", "--block-size", "4"]
    rng = np.random.default_rng(19)
    prompts = [[int(t) for t in rng.integers(0, 512, 4 + i % 5)]
               for i in range(6)]
    rec = run_elastic(argv, prompts, 8, scenario="kill",
                      log_dir=str(tmp_path), env=env, timeout=60.0)
    st = rec["stats"]
    assert rec["reshard_s"] <= HEARTBEAT_TIMEOUT_S + 10.0
    assert st["host_losses"] == 1 and st["reshards"] >= 1
    assert st["grow_backs"] >= 1
    assert st["mesh_shape_current"] == {"tp": 2}
    assert st["healthy_processes"] == st["num_processes"] == 2
    # The CLI's tiny weights are the port's own init (seed 0), carried
    # over to the JAX engine, whose config is the same tiny one.
    from tpushare_torch.models import transformer as tt
    cfg = tt.tiny()
    assert dataclasses.replace(bridge.config_from_jax(TF_CFG),
                               remat=cfg.remat) == cfg
    jparams = jax.tree.map(lambda t: jnp.asarray(t.numpy()),
                           tt.init_params(0, cfg, device="cpu"))
    want = _oracle(prompts, max_tokens=8, tf_params=jparams)
    assert rec["wave1"] == want and rec["wave2"] == want
    assert rec["codes1"] == [200] * 6 and rec["codes2"] == [200] * 6
    restarted = rec["reports"]["rank1_restarted"]
    assert restarted[-1]["digest"] == st["mesh_digest"]
