"""Parity of the port's training path (``tpushare_torch.models.training``
and ``trainer``) with the JAX package's, on the CPU in f32, weights and
optimizer state carried across by ``bridge``.

- ``lm_loss``; ``sgd_train_step`` and ``adamw_train_step`` (3 steps,
  AdamW from a non-zero state through ``bridge.opt_state_from_jax``)
  against the JAX steps, on ``tiny()`` and a Gemma-2-style config
  (window, softcaps, sandwich norms); ``fit`` against the same loop.
- ``forward`` under ``pctx.sp`` and ``make_spmd_train_step`` /
  ``make_adamw_spmd_train_step`` on dp2 x sp2 and dp1 x sp4 gloo groups
  of 4 spawned processes (``tests/torch_spawn.py``; ~10 s each) against
  JAX ``forward`` under ``shard_map`` and the JAX SPMD steps on
  ``make_mesh({"dp": 2, "sp": 2})`` / ``{"sp": 4}``, and against the
  port's own single-process step.
- ``remat`` on and off giving the same gradients, and every refusal
  naming its ROADMAP item.

Tolerances: losses within 1e-5 relative; logits 2e-5 abs; parameters
and moments 2e-6 abs after the steps (an update moves a parameter by
lr times an f32 gradient that the two libraries sum in other orders).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from tpushare.models import training as jtr
from tpushare.models import transformer as jt
from tpushare.parallel.mesh import make_mesh as jax_make_mesh

try:
    from jax import shard_map
except ImportError:  # pragma: no cover - older jax
    from jax.experimental.shard_map import shard_map

import torch_spawn
from tpushare_torch.models import bridge, trainer
from tpushare_torch.models import training as ttr
from tpushare_torch.models import transformer as tt
from tpushare_torch.parallel import mesh as tmesh

LOSS_RTOL = 1e-5
LOGIT_ATOL = 2e-5
PARAM_ATOL = 2e-6
LR, WD, STEPS = 0.05, 0.01, 3

CONFIGS = {
    "tiny": {},
    "gemma2": {"norm_offset": 1.0, "embed_scale": True, "act": "gelu",
               "sliding_window": 6, "alternate_sliding": True,
               "attn_softcap": 20.0, "final_softcap": 15.0,
               "post_norms": True, "attn_scale": 0.15},
}


def _pair(name, seed=0, remat=True):
    jcfg = jt.tiny(remat=remat, **CONFIGS[name])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    if jcfg.post_norms or jcfg.norm_offset:
        # Zero-init norms would hide a wrong offset: give them values.
        rng = np.random.default_rng(seed)
        jp = jax.tree.map(lambda a: a + jnp.asarray(
            rng.normal(size=a.shape) * 0.1, a.dtype) if a.ndim <= 2 else a,
            jp)
    return jcfg, jp, bridge.config_from_jax(jcfg)


def _tparams(jp):
    return bridge.params_from_jax(jp, device="cpu")


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1))


def _opt_state(jp, seed):
    """A non-zero AdamW state (JAX layout, numpy leaves): moments that
    dominate the next gradients, so the update is no near-sign(g) of
    gradients the two libraries round differently."""
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2
                                 ).astype(np.float32), jp)
    nu = jax.tree.map(lambda a: rng.uniform(1e-4, 4e-4, size=a.shape
                                            ).astype(np.float32), jp)
    return {"mu": mu, "nu": nu, "count": np.int32(4)}


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                               atol=0)


def _close_tree(got, want, atol=PARAM_ATOL):
    flat_got = torch_spawn.flatten(got)
    flat_want = torch_spawn.flatten(jax.tree.map(np.asarray, want))
    assert sorted(flat_got) == sorted(flat_want)
    for key in flat_want:
        _close(flat_got[key], flat_want[key], atol)


@functools.lru_cache(maxsize=None)
def _jax_steps(name):
    jcfg = jt.tiny(remat=True, **CONFIGS[name])
    sgd = jax.jit(functools.partial(jtr.sgd_train_step, cfg=jcfg, lr=LR))
    adamw = jax.jit(functools.partial(jtr.adamw_train_step, cfg=jcfg, lr=LR,
                                      weight_decay=WD))
    return sgd, adamw


class TestSingleDevice:
    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_lm_loss(self, name):
        jcfg, jp, tcfg = _pair(name)
        tok = _tokens(1, 2, 12, jcfg.vocab_size)
        want = jtr.lm_loss(jp, jnp.asarray(tok), jcfg)
        got = ttr.lm_loss(_tparams(jp), torch.tensor(tok), tcfg)
        _close_loss(got, want)

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_sgd_steps(self, name):
        jcfg, jp, tcfg = _pair(name)
        sgd, _ = _jax_steps(name)
        tp = _tparams(jp)
        for s in range(STEPS):
            tok = _tokens(10 + s, 2, 12, jcfg.vocab_size)
            jp, jloss = sgd(jp, jnp.asarray(tok))
            tp, tloss = ttr.sgd_train_step(tp, torch.tensor(tok), tcfg,
                                           lr=LR)
            _close_loss(tloss, jloss)
        _close_tree(tp, jp)

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_adamw_steps_from_a_nonzero_state(self, name):
        jcfg, jp, tcfg = _pair(name)
        _, adamw = _jax_steps(name)
        jstate = _opt_state(jp, 3)
        tp, tstate = _tparams(jp), bridge.opt_state_from_jax(jstate,
                                                             device="cpu")
        assert tstate["count"].dtype == torch.int32
        jstate = jax.tree.map(jnp.asarray, jstate)
        for s in range(STEPS):
            tok = _tokens(20 + s, 2, 12, jcfg.vocab_size)
            jp, jstate, jloss = adamw(jp, jstate, jnp.asarray(tok))
            tp, tstate, tloss = ttr.adamw_train_step(
                tp, tstate, torch.tensor(tok), tcfg, lr=LR, weight_decay=WD)
            _close_loss(tloss, jloss)
        _close_tree(tp, jp)
        _close_tree(tstate["mu"], jstate["mu"])
        _close_tree(tstate["nu"], jstate["nu"], atol=1e-8)
        assert int(tstate["count"]) == int(jstate["count"]) == 4 + STEPS

    def test_fit_runs_the_step_loop(self, caplog):
        jcfg, jp, tcfg = _pair("gemma2")
        toks = [torch.tensor(_tokens(30 + s, 2, 12, jcfg.vocab_size))
                for s in range(4)]
        tp = _tparams(jp)
        state = ttr.adamw_init(tp)
        step = functools.partial(ttr.adamw_train_step, cfg=tcfg, lr=LR)
        with caplog.at_level("INFO", logger="tpushare_torch.trainer"):
            tp, state, losses = trainer.fit(step, tp, state, iter(toks),
                                            steps=4, log_every=2,
                                            tokens_per_step=24)
        assert [r.getMessage().split(" loss")[0] for r in caplog.records] \
            == ["step 2", "step 4"]
        assert "tok/s" in caplog.records[-1].getMessage()
        ref = _tparams(jp)
        ref_state = ttr.adamw_init(ref)
        for s, t in enumerate(toks):
            ref, ref_state, loss = ttr.adamw_train_step(ref, ref_state, t,
                                                        tcfg, lr=LR)
            assert float(losses[s]) == float(loss)
        assert int(state["count"]) == 4
        for a, b in zip(ttr.tree_leaves(tp), ttr.tree_leaves(ref)):
            assert torch.equal(a, b)

    @pytest.mark.parametrize("name", list(CONFIGS))
    def test_remat_on_and_off_give_equal_gradients(self, name):
        jcfg, jp, _ = _pair(name)
        tok = torch.tensor(_tokens(5, 2, 12, jcfg.vocab_size))
        grads = {}
        for remat in (True, False):
            tcfg = bridge.config_from_jax(jt.tiny(remat=remat,
                                                  **CONFIGS[name]))
            grads[remat] = ttr.loss_and_grads(_tparams(jp), tok[:, :-1],
                                              tok[:, 1:], tcfg)
        assert float(grads[True][0]) == float(grads[False][0])
        for a, b in zip(ttr.tree_leaves(grads[True][1]),
                        ttr.tree_leaves(grads[False][1])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


SPMD_MESHES = {"dp2_sp2": {"dp": 2, "sp": 2}, "dp1_sp4": {"sp": 4}}


@pytest.fixture(scope="module")
def spmd_runs(tmp_path_factory):
    """The Gemma-2-style config (window 6 spans shards of 4 and 8
    positions) on each mesh: one gloo group of 4 spawned ranks each."""
    tmp = tmp_path_factory.mktemp("spmd")
    jcfg, jp, tcfg = _pair("gemma2")
    tok = _tokens(40, 2, 16, jcfg.vocab_size)
    state = _opt_state(jp, 4)
    inputs = {"tokens": tok, "count": np.asarray(state["count"]),
              **torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"),
              **torch_spawn.flatten(state["mu"], "mu/"),
              **torch_spawn.flatten(state["nu"], "nu/")}
    runs = {name: torch_spawn.run_ranks(torch_spawn.train_worker, 4, tmp,
                                        inputs, tcfg, sizes, LR, 2, WD)
            for name, sizes in SPMD_MESHES.items()}
    return jcfg, jp, tcfg, tok, state, runs


class TestSpmd:
    @pytest.mark.parametrize("mesh_name", list(SPMD_MESHES))
    def test_forward_under_pctx_sp(self, spmd_runs, mesh_name):
        jcfg, jp, tcfg, tok, _, runs = spmd_runs
        mesh = jax_make_mesh(SPMD_MESHES[mesh_name],
                             devices=jax.devices()[:4])
        fwd = jax.jit(shard_map(
            lambda p, t: jt.forward(p, t, jcfg,
                                    pctx=jt.ParallelCtx(sp="sp"))[0],
            mesh=mesh, in_specs=(P(), P("dp", "sp")),
            out_specs=P("dp", "sp")))
        got = runs[mesh_name]["logits"]
        _close(got, fwd(jp, jnp.asarray(tok[:, :-1])), LOGIT_ATOL)
        with torch.no_grad():
            single, _ = tt.forward(_tparams(jp), torch.tensor(tok[:, :-1]),
                                   tcfg)
        _close(got, single, LOGIT_ATOL)

    @pytest.mark.parametrize("mesh_name", list(SPMD_MESHES))
    def test_sgd_step(self, spmd_runs, mesh_name):
        jcfg, jp, tcfg, tok, _, runs = spmd_runs
        got = runs[mesh_name]
        mesh = jax_make_mesh(SPMD_MESHES[mesh_name],
                             devices=jax.devices()[:4])
        step = jtr.make_spmd_train_step(jcfg, mesh, lr=LR)
        tp = _tparams(jp)
        for s in range(2):
            jp, jloss = step(jp, jnp.asarray(tok))
            tp, tloss = ttr.sgd_train_step(tp, torch.tensor(tok), tcfg,
                                           lr=LR)
            _close_loss(got[f"sgd_loss{s}"], jloss)
            _close_loss(got[f"sgd_loss{s}"], tloss)
        spmd = torch_spawn.unflatten(got, "sgd/")
        _close_tree(spmd, jp)
        for a, b in zip(ttr.tree_leaves(spmd), ttr.tree_leaves(tp)):
            _close(a, b, PARAM_ATOL)

    @pytest.mark.parametrize("mesh_name", list(SPMD_MESHES))
    def test_adamw_step(self, spmd_runs, mesh_name):
        jcfg, jp, tcfg, tok, state, runs = spmd_runs
        got = runs[mesh_name]
        mesh = jax_make_mesh(SPMD_MESHES[mesh_name],
                             devices=jax.devices()[:4])
        step = jtr.make_adamw_spmd_train_step(jcfg, mesh, lr=LR,
                                              weight_decay=WD)
        tp = _tparams(jp)
        tstate = bridge.opt_state_from_jax(state, device="cpu")
        jstate = jax.tree.map(jnp.asarray, state)
        for s in range(2):
            jp, jstate, jloss = step(jp, jstate, jnp.asarray(tok))
            tp, tstate, tloss = ttr.adamw_train_step(
                tp, tstate, torch.tensor(tok), tcfg, lr=LR, weight_decay=WD)
            _close_loss(got[f"adamw_loss{s}"], jloss)
            _close_loss(got[f"adamw_loss{s}"], tloss)
        spmd = torch_spawn.unflatten(got, "adamw/")
        _close_tree(spmd, jp)
        _close_tree(torch_spawn.unflatten(got, "adamw_mu/"), jstate["mu"])
        for a, b in zip(ttr.tree_leaves(spmd), ttr.tree_leaves(tp)):
            _close(a, b, PARAM_ATOL)
        assert int(got["adamw_count"]) == int(jstate["count"]) == 6


class TestRefusals:
    def test_each_refusal_names_its_roadmap_item(self):
        cfg = tt.tiny()
        tp = tt.init_params(0, cfg, device="cpu")
        tok = torch.zeros((1, 4), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="ROADMAP A10"):
            tt.forward(tp, tok, cfg, pctx=tt.ParallelCtx(tp="tp"))
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            tt.forward(tp, tok, cfg, pctx=tt.ParallelCtx(sp=object(),
                                                         sp_impl="a2a"))
        with pytest.raises(ValueError, match="sp_impl"):
            tt.forward(tp, tok, cfg, pctx=tt.ParallelCtx(sp_impl="ulysses"))
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            ttr.make_spmd_train_step(cfg, None, sp_impl="a2a")
        for factory in (ttr.make_fsdp_train_step,
                        ttr.make_fsdp_stream_train_step,
                        ttr.make_fsdp_stream_adamw_step):
            with pytest.raises(NotImplementedError, match="ROADMAP A12"):
                factory(cfg, None, lr=1e-3)
        step = functools.partial(ttr.adamw_train_step, cfg=cfg)
        with pytest.raises(NotImplementedError,
                           match="ROADMAP A12.*safetensors"):
            trainer.fit(step, tp, ttr.adamw_init(tp), [], steps=1,
                        ckpt_dir="ckpt")
        with pytest.raises(NotImplementedError, match="benchmark"):
            trainer.fit(step, tp, ttr.adamw_init(tp), [], steps=1,
                        flops_per_step=1e12)

    @pytest.mark.parametrize("sizes,match", [
        ({"tp": 2}, "ROADMAP A10"), ({"ep": 2}, "ROADMAP A10"),
        ({"fsdp": 2}, "ROADMAP A12"), ({"pp": 2}, "ROADMAP A12")])
    def test_make_mesh_refuses_axes_it_does_not_carry(self, sizes, match):
        with pytest.raises(NotImplementedError, match=match):
            tmesh.make_mesh(sizes)

    def test_make_mesh_rejects_unknown_axes(self):
        with pytest.raises(ValueError, match="unknown mesh axes"):
            tmesh.make_mesh({"data": 2})
