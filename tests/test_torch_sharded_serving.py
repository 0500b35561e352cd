"""The port's sharded serving (ROADMAP A10a) against the JAX package's
sharded slot servers, on the CPU in f32.

The JAX servers span NamedSharding meshes of conftest's forced host
devices (placement alone compiles them SPMD); the port's run one process
per rank in gloo groups (``tests/torch_spawn.py``): tp=2 (2 ranks) and
ep=2 x tp=2 (4 ranks), each rank holding its slices and every rank
driving the same schedule. The same weights (JAX ``init_params`` trees,
bridged) and prompts go through both.

- The seven families of ``tests/test_sharded_serving.py`` (dense rows,
  paged, speculative at horizons 1 and 2 over tp; paged MoE, its int8
  speculation and MoE rows over ep x tp) through its ``_drive``
  schedule: greedy streams EQUAL to the JAX sharded server's, and every
  rank's equal to rank 0's; fused and serial admission agree on the
  mesh; prefix sharing is placement-blind.
- The decoder factories (``make_tp_decoder``, ``make_tp_paged_decoder``,
  ``make_moe_decoder``): one prefill and one decode tick's logits within
  1e-4 of the JAX shard_map decoders' largest |logit| (the tp and ep
  sums add f32 partials in another order); each routing under ep x tp
  against JAX's single-device forward (a2a: against the reference's a2a
  with the batch split over ep, its capacity per share), the same
  bound.
- The control plane: rank 0 drives the schedule through a
  ``ShardedServer``, the other ranks ``follow``: equal digests of every
  call's result, a refused admission replayed as a refusal.
- The engine: ``ServeEngine(mesh=)`` on the ep x tp group, the
  reference's TestShardedEngine schedule, then one request over HTTP:
  tokens equal to the JAX sharded engine's, its ``/stats`` mesh and pool
  keys equal, one fetch per tick, and ``POST /mesh/chip`` refused
  naming ROADMAP A10b.
- ``tools/multichip.py --device cpu --tiny`` (BASELINE row 5) as a
  subprocess, every gate held.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import moe as jm
from tpushare.models import quant as jq
from tpushare.models import serving as jserving
from tpushare.models import transformer as jt
from tpushare.models.paged import PagedSlotServer as JPaged
from tpushare.parallel import make_mesh
from tpushare.parallel.sharding import shard_tree as jshard_tree

import torch_spawn
from tpushare_torch.models import bridge

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 4,
    reason="needs XLA_FLAGS=--xla_force_host_platform_device_count=4+")

TF_CFG = jt.tiny(remat=False)
TF_PARAMS = jt.init_params(jax.random.PRNGKey(0), TF_CFG)
MOE_CFG = jm.tiny(remat=False)
MOE_PARAMS = jm.init_params(jax.random.PRNGKey(0), MOE_CFG)
MOE_QDRAFT = jq.quantize_params(MOE_PARAMS, MOE_CFG)
LOGIT_TOL = 1e-4        # of the largest |logit|
TP_FAMILIES = ["dense_tp", "paged_tp", "paged_spec_tp",
               "paged_spec_horizon_tp"]
EPTP_FAMILIES = ["paged_moe_eptp", "paged_moe_spec_eptp", "moe_rows_eptp"]
ROUTINGS = {"psum_dense": {"routing": "psum"},
            "psum_capacity": {"routing": "psum", "capacity_factor": 1.25},
            "a2a": {"routing": "a2a", "capacity_factor": 1.25},
            "dropless": {"routing": "dropless"},
            "expert_choice": {"routing": "expert_choice"}}


def _mesh_tp():
    return make_mesh({"tp": 2}, devices=jax.devices()[:2])


def _mesh_eptp():
    return make_mesh({"tp": 2, "ep": 2}, devices=jax.devices()[:4])


def _prompt(seed, n, vocab):
    return jnp.asarray(np.random.default_rng(seed).integers(0, vocab, n),
                       jnp.int32)


def _unaliased(srv):
    """A fresh host ``active`` array before each call of a JAX server
    (tests/test_torch_paged.py's ``_unaliased``: on the CPU backend
    ``jnp.asarray`` may alias it, and an in-place edit then reaches
    queued device work)."""
    for name in ("admit", "admit_start", "admit_step", "step",
                 "step_async", "evict"):
        fn = getattr(srv, name, None)
        if fn is None:
            continue

        def call(*a, _fn=fn, **kw):
            srv.active = srv.active.copy()
            return _fn(*a, **kw)
        setattr(srv, name, call)
    return srv


def _jax_family(name, mesh):
    if name == "dense_tp":
        return jserving.SlotServer(TF_PARAMS, TF_CFG, n_slots=3,
                                   max_len=96, mesh=mesh)
    if name == "paged_tp":
        return JPaged(TF_PARAMS, TF_CFG, n_slots=3, n_blocks=64,
                      block_size=4, mesh=mesh)
    if name in ("paged_spec_tp", "paged_spec_horizon_tp"):
        return JPaged(TF_PARAMS, TF_CFG, n_slots=3, n_blocks=96,
                      block_size=4, speculative_draft=(TF_PARAMS, TF_CFG),
                      gamma=2, spec_horizon=2 if "horizon" in name else 1,
                      mesh=mesh)
    if name == "paged_moe_eptp":
        return JPaged(MOE_PARAMS, MOE_CFG, n_slots=3, n_blocks=64,
                      block_size=4, forward_fn=jm.paged_forward, mesh=mesh)
    if name == "paged_moe_spec_eptp":
        return JPaged(MOE_PARAMS, MOE_CFG, n_slots=3, n_blocks=96,
                      block_size=4, forward_fn=jm.paged_forward,
                      speculative_draft=(MOE_QDRAFT, MOE_CFG), gamma=2,
                      draft_layers_hook=jq.dequant_hook(MOE_CFG), mesh=mesh,
                      draft_param_specs=jq.quant_moe_param_specs(MOE_CFG))
    if name == "moe_rows_eptp":
        return jm.MoESlotServer(MOE_PARAMS, MOE_CFG, n_slots=3, max_len=96,
                                mesh=mesh)
    raise KeyError(name)


def _ints(t):
    return [int(x) for x in t] if isinstance(t, (list, tuple)) else [int(t)]


def _jax_drive(srv, long_prompt, ticks=8, chunk=8):
    """test_sharded_serving.py's ``_drive`` on a JAX server, with the
    port worker's key spelling."""
    vocab = srv.cfg.vocab_size
    srv = _unaliased(srv)
    s0 = srv.admit(_prompt(1, 6, vocab))
    streams = {s0: [int(srv.last_token[s0, 0])]}
    a = srv.admit_start(long_prompt, chunk_tokens=chunk)
    admitted = []
    for _ in range(ticks):
        if a is not None:
            out = srv.step(prefill_work=a)
            if a in out:
                admitted.append(int(out.pop(a)))
                a = None
        else:
            out = srv.step()
        for s, t in out.items():
            streams.setdefault(s, []).extend(_ints(t))
    return [{str(k): v for k, v in streams.items()}, admitted]


def _cfg_json(cfg):
    fields = dict(vars(cfg))
    fields.pop("dtype")
    return json.dumps(fields)


def _dec_inputs():
    rng = np.random.default_rng(3)
    L, Hkv, Dh = TF_CFG.n_layers, TF_CFG.n_kv_heads, TF_CFG.head_dim
    nb, bs, B = 16, 4, 2
    table = np.full((B, 4), -1, np.int32)
    table[0, :3] = [3, 7, 1]
    table[1, :2] = [9, 2]
    return {
        "dec_tokens": rng.integers(0, 256, (B, 5)).astype(np.int64),
        "route_tokens": rng.integers(0, MOE_CFG.vocab_size,
                                     (2, 9)).astype(np.int64),
        "pool": rng.normal(size=(L, nb, bs, Hkv, Dh)).astype(np.float32),
        "table": table, "lengths": np.array([9, 6], np.int32)}


def _inputs():
    inp = {"tcfg": np.array(_cfg_json(bridge.config_from_jax(TF_CFG))),
           "mcfg": np.array(_cfg_json(bridge.moe_config_from_jax(MOE_CFG)))}
    for prefix, tree in (("tf/", TF_PARAMS), ("moe/", MOE_PARAMS),
                         ("moeq/", MOE_QDRAFT)):
        inp.update(torch_spawn.flatten(jax.tree.map(np.asarray, tree),
                                       prefix))
    inp.update(_dec_inputs())
    return inp


def _jax_a2a_over_ep(cfg, toks):
    """The reference's a2a with ep a data axis: the batch split over ep
    inside shard_map (each ep rank routes its own rows, capacity per
    share), the experts over ep x tp."""
    from jax.sharding import PartitionSpec as JP
    from tpushare.models.serving import shard_map
    from tpushare.models.transformer import ParallelCtx as JCtx
    mesh = _mesh_eptp()
    specs = jm.param_specs(cfg)
    fn = shard_map(
        lambda p, t: jm.forward(p, t, cfg, pctx=JCtx(tp="tp"),
                                ep_axis="ep")[0],
        mesh=mesh, in_specs=(specs, JP("ep", None)),
        out_specs=JP("ep", None, None))
    return fn(jshard_tree(MOE_PARAMS, mesh, specs), toks)


def _res(run, key="res"):
    return json.loads(str(run[key]))


@pytest.fixture(scope="module")
def tp_run(tmp_path_factory):
    return torch_spawn.run_ranks(
        torch_spawn.sharded_serving_worker, 2,
        tmp_path_factory.mktemp("tp"), _inputs(), {"tp": 2}, TP_FAMILIES,
        ("fused", "decoders", "control"), timeout=240.0)


@pytest.fixture(scope="module")
def eptp_run(tmp_path_factory):
    return torch_spawn.run_ranks(
        torch_spawn.sharded_serving_worker, 4,
        tmp_path_factory.mktemp("eptp"), _inputs(), {"tp": 2, "ep": 2},
        EPTP_FAMILIES, ("prefix", "decoders", "routings", "engine"),
        timeout=240.0)


def _close(got, want, tol=LOGIT_TOL):
    want = np.asarray(want, np.float32)
    err = float(np.abs(np.asarray(got, np.float32) - want).max()
                / np.abs(want).max())
    assert err <= tol, err


class TestShardedParity:
    @pytest.mark.parametrize("family", TP_FAMILIES + EPTP_FAMILIES)
    def test_matches_jax_sharded(self, family, tp_run, eptp_run):
        """Greedy streams equal to the JAX server's on the same mesh
        shape, and every rank's equal to rank 0's."""
        run = _res(tp_run if family in TP_FAMILIES else eptp_run)
        mesh = (_mesh_tp if family in TP_FAMILIES else _mesh_eptp)()
        vocab = (MOE_CFG if "moe" in family else TF_CFG).vocab_size
        want = _jax_drive(_jax_family(family, mesh), _prompt(7, 21, vocab))
        assert run[family] == want, family
        assert run[family + "/ranks_equal"] is True

    def test_sharded_fused_matches_sharded_serial(self, tp_run):
        run = _res(tp_run)["fused"]
        a1, s1 = run["fused"]
        a2, s2 = run["serial"]
        assert a1 == a2
        for s in s1:
            n = min(len(s1[s]), len(s2[s]))
            assert s1[s][:n] == s2[s][:n]

    def test_prefix_sharing_is_placement_blind(self, eptp_run):
        srv = _unaliased(JPaged(MOE_PARAMS, MOE_CFG, n_slots=2, n_blocks=32,
                                block_size=4, forward_fn=jm.paged_forward,
                                prefix_cache=True, mesh=_mesh_eptp()))
        prompt = _prompt(13, 13, MOE_CFG.vocab_size)
        a = srv.admit(prompt)
        first = int(srv.last_token[a, 0])
        srv.evict(a)
        b = srv.admit(prompt)
        want = [srv.last_cached_len, first, int(srv.last_token[b, 0]),
                len(srv.cache.free), srv.cache.live_blocks()]
        assert _res(eptp_run)["prefix"] == want

    def test_tp_decoders(self, tp_run):
        d = _dec_inputs()
        mesh = _mesh_tp()
        pre, dec = jserving.make_tp_decoder(TF_CFG, mesh)
        p = jshard_tree(TF_PARAMS, mesh, jt.param_specs(TF_CFG))
        toks = jnp.asarray(d["dec_tokens"], jnp.int32)
        cache = jserving.sharded_cache(TF_CFG, mesh, toks.shape[0], 32)
        lg, cache = pre(p, toks, cache)
        _close(tp_run["tp_prefill"], lg)
        lg, cache = dec(p, toks[:, :1], cache, toks.shape[1])
        _close(tp_run["tp_decode"], lg)
        pd = jserving.make_tp_paged_decoder(TF_CFG, mesh, block_size=4)
        sh = jax.sharding.NamedSharding(mesh, jserving.paged_pool_specs())
        pool = jnp.asarray(d["pool"])
        lg, _, _, lens = pd(p, toks[:, :1], jax.device_put(pool, sh),
                            jax.device_put(pool * 0.5, sh),
                            jnp.asarray(d["table"]),
                            jnp.asarray(d["lengths"]),
                            jnp.ones((toks.shape[0],), bool))
        _close(tp_run["tp_paged"], lg)
        np.testing.assert_array_equal(tp_run["tp_paged_lengths"],
                                      np.asarray(lens))

    def test_moe_decoders(self, eptp_run):
        d = _dec_inputs()
        mesh = _mesh_eptp()
        pre, dec = jserving.make_moe_decoder(MOE_CFG, mesh)
        p = jshard_tree(MOE_PARAMS, mesh, jm.param_specs(MOE_CFG))
        toks = jnp.asarray(d["dec_tokens"], jnp.int32)
        cache = jserving.sharded_cache(MOE_CFG, mesh, toks.shape[0], 32)
        lg, cache = pre(p, toks, cache)
        _close(eptp_run["moe_prefill"], lg)
        lg, cache = dec(p, toks[:, :1], cache, toks.shape[1])
        _close(eptp_run["moe_decode"], lg)

    @pytest.mark.parametrize("routing", sorted(ROUTINGS) + ["psum_q8"])
    def test_routing_under_ep_tp(self, routing, eptp_run):
        """Each routing's experts over ep x tp against JAX's
        single-device forward (int8 experts: the fused path against
        JAX's widened leaves)."""
        import dataclasses
        toks = jnp.asarray(_dec_inputs()["route_tokens"], jnp.int32)
        if routing == "psum_q8":
            want, _ = jm.forward(MOE_QDRAFT, toks, MOE_CFG,
                                 layers_hook=jq.dequant_hook(MOE_CFG))
        elif routing == "a2a":
            want = _jax_a2a_over_ep(
                dataclasses.replace(MOE_CFG, **ROUTINGS[routing]), toks)
        else:
            cfg = dataclasses.replace(MOE_CFG, **ROUTINGS[routing])
            want, _ = jm.forward(MOE_PARAMS, toks, cfg)
        _close(eptp_run[f"route/{routing}"], want)


class TestControlPlane:
    def test_followers_replay_rank_zeros_calls(self, tp_run):
        ranks = json.loads(str(tp_run["control"]))
        r0 = ranks[0]
        assert "no free slots" in r0["caught"]
        assert {r["digest"] for r in ranks} == {r0["digest"]}
        # Every replayed call: the schedule's and the refused admission.
        assert ranks[1]["calls"] >= 10
        assert r0["broadcasts"] > ranks[1]["calls"]   # + raised, pings, stop
        want = _jax_drive(_jax_family("paged_tp", _mesh_tp()),
                          _prompt(7, 21, TF_CFG.vocab_size))
        # n_slots 2 instead of 3: the same two streams.
        assert r0["streams"] == want


class TestShardedEngine:
    PROMPTS = [[5, 9, 12, 3], list(range(40, 70)), [9, 9, 2]]
    KEYS = ("mesh_shape", "num_devices", "mesh_shape_configured",
            "mesh_shape_current", "num_devices_configured",
            "healthy_devices", "degraded", "free_blocks",
            "reclaimable_blocks", "live_blocks", "forwards_per_tick")

    @pytest.fixture(scope="class")
    def jax_engine(self):
        from tpushare.cli import serve as jserve
        eng = jserve.ServeEngine(
            MOE_PARAMS, MOE_CFG, model_family="moe", kv="paged",
            n_slots=4, n_blocks=128, block_size=4, idle_sleep_s=0.0,
            prefill_chunk=8, mesh=_mesh_eptp())
        _unaliased(eng.srv)
        out = []
        for prompts in (self.PROMPTS, [[7, 7, 3]]):
            reqs = [jserve._Request(list(p), 5, None) for p in prompts]
            for r in reqs:
                assert eng.submit(r)
            for _ in range(400):
                if all(r.done.is_set() for r in reqs):
                    break
                eng._loop_once()
            out.append([list(r.tokens) for r in reqs])
        return out, eng.stats()

    def test_engine_matches_jax_sharded_engine(self, eptp_run, jax_engine):
        ranks = json.loads(str(eptp_run["engine"]))
        r0 = ranks[0]
        want, _ = jax_engine
        assert r0["errors"] == [None] * 3
        assert r0["tokens"] == want[0]
        assert r0["http_tokens"] == want[1][0]
        digests = {r0["stats"]["mesh_digest"]} | {
            r["digest"] for r in ranks[1:]}
        assert len(digests) == 1

    def test_stats_mesh_observability(self, eptp_run, jax_engine):
        st = json.loads(str(eptp_run["engine"]))[0]["stats"]
        _, jst = jax_engine
        assert {k: st[k] for k in self.KEYS} == {k: jst[k]
                                                 for k in self.KEYS}
        assert st["mesh_shape"] == {"ep": 2, "tp": 2}
        assert st["fetches_per_tick"] <= 1.0
        assert st["fused_ticks"] >= 1
        assert st["mesh_transport"] == "gloo"

    def test_chip_events_on_a_mesh_name_a10b(self, eptp_run):
        code, err = json.loads(str(eptp_run["engine"]))[0]["chip"]
        assert code == 400 and "A10b" in err


def test_multichip_tool_on_the_host():
    """tools/multichip.py (BASELINE row 5) end to end on the CPU: the
    placement on the fake four-card host, the tp=2 engine's two rank
    processes, the ep=2 MoE ranks and the two small pods, every gate
    held."""
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.tools.multichip", "--device",
         "cpu", "--tiny"], cwd=root, env=env, capture_output=True,
        text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    record = json.loads(out.stdout.strip().splitlines()[-1])
    assert record["failures"] == []
    assert record["A"]["grants"]["serving"].count(",") == 1
    bc = record["BC"]
    assert bc["stats"]["mesh_shape"] == {"tp": 2}
    assert bc["transport"] == "gloo"
    assert set(bc["moe"]) == {"psum", "a2a"}
    assert len(record["D"]["tenants"]) == 2
