"""Parity of the port's pipeline parallelism (``tpushare_torch.models.
pipeline``, ``moe_pipeline``) with the JAX package's, on the CPU in f32.

- GPipe at pp 2, pp 4 and pp 2 x dp 2, in gloo groups of spawned ranks
  (``tests/torch_spawn.py``), against JAX's ``make_pp_train_step`` on a
  mesh of virtual CPU devices, in this process.
- 1F1B, interleaved and a 1F1B AdamW step (from a non-zero state) in the
  same groups, against JAX's single-device step, which the reference's
  own tests hold those schedules to (its 1F1B programs run in
  subprocesses with retries, ``tests/test_pipeline.py``; none runs
  here). The same for pp 2 x sp 2 with ring attention and a
  Gemma-2-style config (alternating windows that cross shards, both
  softcaps, sandwich norms), and for every schedule at pp 1 in process.
- ``build_interleaved_schedule`` and ``interleaved_layer_order`` equal
  to JAX's over a grid; ``to_interleaved_storage`` and the windows.
- The MoE pipeline at pp 2 (psum, dropless, an untied head; SGD and
  AdamW) against the per-microbatch JAX objective
  (``tests/test_moe_pipeline.py``'s oracle); "a2a" refused, ep that
  does not divide the experts refused; a mesh with ep or tp builds
  (their parity: tests/test_torch_pp_tp.py).

Tolerances: losses 1e-5 relative; parameters and moments 2e-6 abs after
a step (f32 gradients summed in other orders, scaled by lr; the AdamW
state is non-zero, so no update is a near-sign(g) of tiny gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import moe as jmoe
from tpushare.models import pipeline as jpl
from tpushare.models import training as jtr
from tpushare.models import transformer as jt
from tpushare.parallel import shard_tree
from tpushare.parallel.mesh import make_mesh as jax_make_mesh

import torch_spawn
from tpushare_torch.models import bridge
from tpushare_torch.models import moe_pipeline as tmp_
from tpushare_torch.models import pipeline as tpl
from tpushare_torch.models import training as ttr

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
LR, WD = 0.1, 0.01
GEMMA2 = {"norm_offset": 1.0, "embed_scale": True, "act": "gelu",
          "sliding_window": 8, "alternate_sliding": True,
          "attn_softcap": 30.0, "final_softcap": 15.0, "post_norms": True,
          "attn_scale": 0.15}
# name: (mesh, layers, microbatches, batch, seq, config, schedules, adamw)
GROUPS = {
    "pp2": ({"pp": 2}, 4, 2, 4, 16, {}, ("gpipe", "1f1b", "interleaved"),
            True),
    "pp4": ({"pp": 4}, 8, 4, 4, 16, {}, ("gpipe", "1f1b", "interleaved"),
            False),
    "pp2_dp2": ({"pp": 2, "dp": 2}, 4, 2, 4, 16, {}, ("gpipe", "1f1b"),
                True),
    "pp2_sp2": ({"pp": 2, "sp": 2}, 4, 2, 4, 32, GEMMA2,
                ("gpipe", "1f1b", "interleaved"), False),
}
GPIPE_ORACLE = ("pp2", "pp4", "pp2_dp2")


def _jparams(jcfg, seed=0):
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.post_norms or jcfg.norm_offset:
        # Zero-init norms would hide a wrong offset: give them values.
        rng = np.random.default_rng(seed)
        jp = jax.tree.map(lambda a: a + jnp.asarray(
            rng.normal(size=a.shape) * 0.1, a.dtype) if a.ndim <= 2 else a,
            jp)
    return jp


def _opt_state(jp, seed):
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2
                                 ).astype(np.float32), jp)
    nu = jax.tree.map(lambda a: rng.uniform(1e-4, 4e-4, size=a.shape
                                            ).astype(np.float32), jp)
    return {"mu": mu, "nu": nu, "count": np.int32(4)}


def _close_tree(got, want, prefix="", atol=PARAM_ATOL):
    flat_want = torch_spawn.flatten(jax.tree.map(np.asarray, want))
    for key, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(got[prefix + key],
                                              np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=prefix + key)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@functools.lru_cache(maxsize=None)
def _group(name):
    sizes, L, M, B, S, kw, scheds, adamw = GROUPS[name]
    jcfg = jt.tiny(remat=False, n_layers=L, **kw)
    jp = _jparams(jcfg)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (B, S + 1))
    return jcfg, jp, tok


@pytest.fixture(scope="module")
def pp_runs(tmp_path_factory):
    """Each group of GROUPS as one gloo group of spawned ranks."""
    tmp = tmp_path_factory.mktemp("pp")
    out = {}
    for name, (sizes, L, M, B, S, kw, scheds, adamw) in GROUPS.items():
        jcfg, jp, tok = _group(name)
        inputs = {"tokens": tok,
                  **torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/")}
        if adamw:
            st = _opt_state(jp, 3)
            inputs.update(count=np.asarray(st["count"]),
                          **torch_spawn.flatten(st["mu"], "mu/"),
                          **torch_spawn.flatten(st["nu"], "nu/"))
        world = int(np.prod(list(sizes.values())))
        out[name] = torch_spawn.run_ranks(
            torch_spawn.pp_worker, world, tmp, inputs,
            bridge.config_from_jax(jcfg), sizes, M, LR, WD, scheds)
    return out


@functools.lru_cache(maxsize=None)
def _jax_single(name):
    """JAX's single-device SGD step (and AdamW step from the group's
    non-zero state) on the group's batch."""
    jcfg, jp, tok = _group(name)
    new, loss = jax.jit(functools.partial(
        jtr.sgd_train_step, cfg=jcfg, lr=LR))(jp, jnp.asarray(tok))
    out = {"sgd": new, "sgd_loss": float(loss)}
    if GROUPS[name][-1]:
        st = jax.tree.map(jnp.asarray, _opt_state(jp, 3))
        p, st, loss = jax.jit(functools.partial(
            jtr.adamw_train_step, cfg=jcfg, lr=LR, weight_decay=WD))(
                jp, st, jnp.asarray(tok))
        out.update(adamw=p, adamw_mu=st["mu"], adamw_count=int(st["count"]),
                   adamw_loss=float(loss))
    return out


class TestGPipeAgainstJaxPipeline:
    @pytest.mark.parametrize("name", GPIPE_ORACLE)
    def test_gpipe_step(self, pp_runs, name):
        sizes, L, M = GROUPS[name][:3]
        jcfg, jp, tok = _group(name)
        n = int(np.prod(list(sizes.values())))
        mesh = jax_make_mesh(sizes, devices=jax.devices()[:n])
        step = jpl.make_pp_train_step(jcfg, mesh, n_microbatches=M, lr=LR)
        new, loss = step(shard_tree(jp, mesh, jpl.param_specs(jcfg)),
                         jnp.asarray(tok))
        got = pp_runs[name]
        _close_loss(got["gpipe_loss"], loss)
        _close_tree(got, new, "gpipe/")


class TestSchedulesAgainstSingleDevice:
    @pytest.mark.parametrize("name,sched", [
        (n, s) for n, g in GROUPS.items() for s in g[6]])
    def test_sgd_step(self, pp_runs, name, sched):
        want = _jax_single(name)
        got = pp_runs[name]
        _close_loss(got[f"{sched}_loss"], want["sgd_loss"])
        _close_tree(got, want["sgd"], f"{sched}/")

    @pytest.mark.parametrize("name", [n for n, g in GROUPS.items() if g[-1]])
    def test_adamw_1f1b_step(self, pp_runs, name):
        want = _jax_single(name)
        got = pp_runs[name]
        _close_loss(got["adamw_loss"], want["adamw_loss"])
        _close_tree(got, want["adamw"], "adamw/")
        _close_tree(got, want["adamw_mu"], "adamw_mu/")
        assert int(got["adamw_count"]) == want["adamw_count"] == 5


class _StubMesh:
    """A mesh whose named axes are given (none: every axis size 1)."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, dim=None):
        return self._sizes[dim]

    def get_group(self, name):
        return None


class TestOneStageInProcess:
    """pp 1 needs no process group: every schedule against JAX's
    single-device step on the Gemma-2-style config."""

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _want():
        jcfg = jt.tiny(remat=True, n_layers=4, **GEMMA2)
        jp = _jparams(jcfg, 5)
        tok = np.random.default_rng(6).integers(0, jcfg.vocab_size, (4, 13))
        want, wloss = jax.jit(functools.partial(
            jtr.sgd_train_step, cfg=jcfg, lr=LR))(jp, jnp.asarray(tok))
        return jcfg, jp, tok, want, wloss

    @pytest.mark.parametrize("sched", ["gpipe", "1f1b", "interleaved"])
    def test_schedule(self, sched):
        jcfg, jp, tok, want, wloss = self._want()
        tp = bridge.params_from_jax(jp, device="cpu")
        if sched == "interleaved":
            tp = tpl.to_interleaved_storage(tp, 1, 2)
        step = tpl.make_pp_train_step(bridge.config_from_jax(jcfg),
                                      _StubMesh(), n_microbatches=2, lr=LR,
                                      schedule=sched)
        tp, loss = step(tp, torch.tensor(tok))
        _close_loss(loss, wloss)
        _close_tree(torch_spawn.flatten(tp), want)

    def test_adamw(self):
        jcfg = jt.tiny(remat=False, n_layers=2, **GEMMA2)
        jp = _jparams(jcfg, 7)
        tok = np.random.default_rng(8).integers(0, jcfg.vocab_size, (2, 9))
        st = _opt_state(jp, 9)
        want, wst, wloss = jax.jit(functools.partial(
            jtr.adamw_train_step, cfg=jcfg, lr=LR, weight_decay=WD))(
                jp, jax.tree.map(jnp.asarray, st), jnp.asarray(tok))
        step = tpl.make_pp_adamw_train_step(
            bridge.config_from_jax(jcfg), _StubMesh(), n_microbatches=2,
            lr=LR, weight_decay=WD)
        tp, tst, loss = step(bridge.params_from_jax(jp, device="cpu"),
                             bridge.opt_state_from_jax(st, device="cpu"),
                             torch.tensor(tok))
        _close_loss(loss, wloss)
        _close_tree(torch_spawn.flatten(tp), want)
        _close_tree(torch_spawn.flatten(tst["nu"]), wst["nu"], atol=1e-8)


class TestInterleavedTables:
    def test_schedule_equals_jax_over_a_grid(self):
        for P in (1, 2, 3, 4):
            for v in (1, 2, 3):
                for M in range(P, 3 * P + 1, P):
                    assert tpl.build_interleaved_schedule(P, v, M) == \
                        jpl.build_interleaved_schedule(P, v, M), (P, v, M)
        for bad in ((2, 2, 3), (4, 2, 6)):
            with pytest.raises(ValueError, match="divisible"):
                tpl.build_interleaved_schedule(*bad)

    def test_layer_order_and_storage_equal_jax(self):
        for L, P, v in ((4, 2, 2), (8, 2, 2), (8, 4, 2), (12, 2, 3),
                        (6, 3, 1), (18, 1, 2)):
            assert tpl.interleaved_layer_order(L, P, v) == \
                jpl.interleaved_layer_order(L, P, v)
        with pytest.raises(ValueError, match="not divisible"):
            tpl.interleaved_layer_order(4, 4, 2)
        jcfg = jt.tiny(remat=False, n_layers=8)
        jp = _jparams(jcfg)
        want = jpl.to_interleaved_storage(jp, 2, 2)
        got = tpl.to_interleaved_storage(
            bridge.params_from_jax(jp, device="cpu"), 2, 2)
        _close_tree(torch_spawn.flatten(got), want, atol=0)

    def test_local_windows_follow_storage_order(self):
        cfg = bridge.config_from_jax(jt.tiny(remat=False, n_layers=8,
                                             **GEMMA2))
        model = [8 if l % 2 == 0 else 0 for l in range(8)]
        assert tpl.local_layer_windows(cfg, 2, 1) == model[4:]
        perm = tpl.interleaved_layer_order(8, 2, 2)
        assert tpl.local_layer_windows(cfg, 2, 0, interleaved_v=2) == \
            [model[i] for i in perm[:4]]
        assert tpl.local_layer_windows(bridge.config_from_jax(
            jt.tiny(n_layers=4)), 2, 0) is None


MOE_CASES = {"psum": {"routing": "psum"},
             "dropless": {"routing": "dropless"},
             "untied": {"routing": "psum", "tie_embeddings": False}}


def _moe_pair(name):
    jcfg = jmoe.tiny(remat=False, n_layers=4, **MOE_CASES[name])
    return jcfg, jmoe.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_pp")
    tok = np.random.default_rng(2).integers(0, 256, (4, 17))
    inputs, cases = {"tokens": tok, "count": np.int32(4)}, []
    for name in MOE_CASES:
        jcfg, jp = _moe_pair(name)
        st = _opt_state(jp, 5)
        inputs.update(**torch_spawn.flatten(jax.tree.map(np.asarray, jp),
                                            f"{name}/p/"),
                      **torch_spawn.flatten(st["mu"], f"{name}/mu/"),
                      **torch_spawn.flatten(st["nu"], f"{name}/nu/"))
        cases.append((name, bridge.moe_config_from_jax(jcfg)))
    got = torch_spawn.run_ranks(torch_spawn.moe_pp_worker, 2, tmp, inputs,
                                cases, {"pp": 2}, 2, LR, WD)
    return tok, got


class TestMoEPipeline:
    @pytest.mark.parametrize("name", list(MOE_CASES))
    def test_matches_the_per_microbatch_objective(self, moe_runs, name):
        tok, got = moe_runs
        jcfg, jp = _moe_pair(name)
        toks = jnp.asarray(tok)

        def loss_fn(p):
            return jnp.mean(jnp.stack([jmoe.lm_loss(p, toks[i * 2:
                                                           (i + 1) * 2],
                                                    jcfg)
                                       for i in range(2)]))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
        _close_loss(got[f"{name}/sgd_loss"], loss)
        _close_tree(got, jtr._sgd_update(jp, grads, LR), f"{name}/sgd/")
        st = jax.tree.map(jnp.asarray, _opt_state(jp, 5))
        new, _ = jtr.apply_adamw(jp, grads, st, lr=LR, weight_decay=WD)
        _close_loss(got[f"{name}/adamw_loss"], loss)
        _close_tree(got, new, f"{name}/adamw/")

    def test_refusals(self):
        from tpushare_torch.models import moe as tmoe
        cfg = tmoe.tiny(remat=False, routing="a2a", capacity_factor=2.0)
        p = tmoe.init_params(0, cfg, device="cpu")
        tok = torch.zeros((2, 8), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="a2a"):
            tmp_.moe_pipelined_lm_loss(p, tok, tok, cfg, pp_group=None,
                                       n_microbatches=2)
        with pytest.raises(ValueError, match="divide"):
            tmp_.make_moe_pp_train_step(tmoe.tiny(n_experts=3),
                                        _StubMesh(ep=2), n_microbatches=2)
        # pp x ep x tp is ported (ROADMAP A10c; tests/test_torch_pp_tp.py):
        # a mesh with either builds, as the reference's does.
        for axis in ("ep", "tp"):
            step = tmp_.make_moe_pp_adamw_train_step(
                tmoe.tiny(), _StubMesh(**{axis: 2}), n_microbatches=2)
            assert callable(step)


class TestRefusals:
    def test_schedule_and_axes(self):
        cfg = bridge.config_from_jax(jt.tiny(remat=False))
        with pytest.raises(ValueError, match="unknown pipeline schedule"):
            tpl.make_pp_train_step(cfg, _StubMesh(), n_microbatches=2,
                                   schedule="zb")
        # pp x tp is ported (ROADMAP A10c; tests/test_torch_pp_tp.py);
        # ep stays refused by design: the dense LM has no experts.
        assert callable(tpl.make_pp_adamw_train_step(
            cfg, _StubMesh(tp=2), n_microbatches=2))
        with pytest.raises(NotImplementedError, match="no experts"):
            tpl.make_pp_adamw_train_step(cfg, _StubMesh(ep=2),
                                         n_microbatches=2)
        with pytest.raises(ValueError, match="microbatches"):
            tpl.pipelined_lm_loss(
                tpl.stage_params(ttr.tree_map(
                    lambda t: t, bridge.params_from_jax(
                        _jparams(jt.tiny(remat=False)), device="cpu")), 1, 0),
                torch.zeros((3, 4), dtype=torch.long),
                torch.zeros((3, 4), dtype=torch.long), cfg, pp_group=None,
                n_microbatches=2)
