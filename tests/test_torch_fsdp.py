"""Parity of the port's manual fsdp steps and flat-storage checkpoints
(``tpushare_torch.models.training``, ``utils/checkpoint.py``) with the
JAX package's, on the CPU in f32.

- ``fsdp_shard_params`` / ``fsdp_stream_shard_params`` give JAX's global
  leaves, padding included, and their inverses and ``fsdp_local``'s
  slices put them back.
- ``make_fsdp_train_step``, ``make_fsdp_stream_train_step`` and
  ``make_fsdp_stream_adamw_step`` (AdamW from a non-zero state) at fsdp
  2 and 4, two steps each, in gloo groups of spawned ranks
  (``tests/torch_spawn.py``), against JAX's steps on ``{"fsdp": F}``
  meshes of virtual CPU devices: losses and the gathered, unsharded
  params and moments.
- A flat AdamW checkpoint written at fsdp 4 restores at 4 (each rank's
  slices equal what it saved) and at 2 (the same whole state), and
  ``FlatShard`` restores read one rank's slices at any size in process.
- The refusals: streaming without remat, tp, pp, the SPMD step over an
  fsdp axis, and placements other than flat fsdp storage.

Tolerances: losses 1e-5 relative; parameters and moments 2e-6 abs
after the steps (an update moves a parameter by lr times an f32
gradient that the two libraries sum in other orders; the AdamW state is
non-zero, so no update is a near-sign(g) of tiny gradients).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import training as jtr
from tpushare.models import transformer as jt
from tpushare.parallel.mesh import make_mesh as jax_make_mesh

import torch_spawn
from tpushare_torch.models import bridge, trainer
from tpushare_torch.models import training as ttr
from tpushare_torch.models import transformer as tt
from tpushare_torch.utils import checkpoint

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
LR, WD, STEPS = 0.05, 0.01, 2
GEMMA2 = {"norm_offset": 1.0, "embed_scale": True, "act": "gelu",
          "sliding_window": 6, "alternate_sliding": True,
          "attn_softcap": 20.0, "final_softcap": 15.0, "post_norms": True,
          "attn_scale": 0.15}
SIZES = (2, 4)


def _pair(seed=0):
    jcfg = jt.tiny(remat=True, **GEMMA2)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    # Zero-init norms would hide a wrong offset: give them values.
    jp = jax.tree.map(lambda a: a + jnp.asarray(
        rng.normal(size=a.shape) * 0.1, a.dtype) if a.ndim <= 2 else a, jp)
    return jcfg, jp, bridge.config_from_jax(jcfg)


def _opt_state(jp, seed):
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2
                                 ).astype(np.float32), jp)
    nu = jax.tree.map(lambda a: rng.uniform(1e-4, 4e-4, size=a.shape
                                            ).astype(np.float32), jp)
    return {"mu": mu, "nu": nu, "count": np.int32(4)}


def _close_tree(got, want, atol=PARAM_ATOL, prefix=""):
    flat_want = torch_spawn.flatten(jax.tree.map(np.asarray, want))
    for key, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(got[prefix + key], np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=key)


def _jax_runs(jcfg, jp, state, tok, F):
    """JAX's three fsdp steps on {"fsdp": F}: losses and unsharded
    trees."""
    mesh = jax_make_mesh({"fsdp": F}, devices=jax.devices()[:F])
    out = {}
    tok = jnp.asarray(tok)
    for name, factory, unshard in (
            ("plain", jtr.make_fsdp_train_step, jtr.fsdp_unshard_params),
            ("stream", jtr.make_fsdp_stream_train_step,
             jtr.fsdp_stream_unshard_params)):
        step, shard = factory(jcfg, mesh, lr=LR)
        flat = shard(jp)
        for s in range(STEPS):
            flat, loss = step(flat, tok)
            out[f"{name}_loss{s}"] = float(loss)
        out[name] = unshard(flat, jp)
    step, shard, opt_init = jtr.make_fsdp_stream_adamw_step(
        jcfg, mesh, lr=LR, weight_decay=WD)
    flat = shard(jp)
    st = {"mu": shard(state["mu"]), "nu": shard(state["nu"]),
          "count": jnp.asarray(state["count"])}
    for s in range(STEPS):
        flat, st, loss = step(flat, st, tok)
        out[f"adamw_loss{s}"] = float(loss)
    out["adamw"] = jtr.fsdp_stream_unshard_params(flat, jp)
    out["adamw_mu"] = jtr.fsdp_stream_unshard_params(st["mu"], jp)
    out["adamw_count"] = int(st["count"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """For fsdp 2 and 4: the port's gloo group (the fsdp-4 group saves
    its AdamW state as a flat checkpoint) and JAX's steps; then a group
    of 2 restoring the fsdp-4 checkpoint."""
    tmp = tmp_path_factory.mktemp("fsdp")
    jcfg, jp, tcfg = _pair()
    state = _opt_state(jp, 3)
    tok = np.random.default_rng(4).integers(0, jcfg.vocab_size, (4, 17))
    inputs = {"tokens": tok, "count": np.asarray(state["count"]),
              **torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"),
              **torch_spawn.flatten(state["mu"], "mu/"),
              **torch_spawn.flatten(state["nu"], "nu/")}
    ckpt = str(tmp / "flat_f4")
    out = {}
    for F in SIZES:
        out[F] = {
            "port": torch_spawn.run_ranks(
                torch_spawn.fsdp_worker, F, tmp, inputs, tcfg, {"fsdp": F},
                LR, STEPS, WD, ckpt if F == 4 else None),
            "jax": _jax_runs(jcfg, jp, state, tok, F)}
    out["restore_f2"] = torch_spawn.run_ranks(
        torch_spawn.fsdp_restore_worker, 2, tmp, {"tokens": tok}, tcfg,
        {"fsdp": 2}, ckpt)
    return jp, out


class TestLayouts:
    @pytest.mark.parametrize("n_shards", [1, 3, 4])
    def test_both_layouts_equal_jax_padding_included(self, n_shards):
        jcfg, jp, tcfg = _pair(1)
        tp = bridge.params_from_jax(jp, device="cpu")
        like = tt.init_params(0, tcfg, device="meta")
        for stream, port, ref, unport in (
                (False, ttr.fsdp_shard_params, jtr.fsdp_shard_params,
                 ttr.fsdp_unshard_params),
                (True, ttr.fsdp_stream_shard_params,
                 jtr.fsdp_stream_shard_params,
                 ttr.fsdp_stream_unshard_params)):
            got, want = port(tp, n_shards), ref(jp, n_shards)
            flat_got = torch_spawn.flatten(got)
            for key, w in torch_spawn.flatten(
                    jax.tree.map(np.asarray, want)).items():
                assert flat_got[key].shape == w.shape, key
                np.testing.assert_array_equal(flat_got[key], w)
            back = unport(got, like)
            for a, b in zip(ttr.tree_leaves(back), ttr.tree_leaves(tp)):
                assert torch.equal(a, b)
            parts = [ttr.fsdp_local(got, n_shards, i, stream=stream)
                     for i in range(n_shards)]
            for a, *ps in zip(ttr.tree_leaves(got),
                              *[ttr.tree_leaves(p) for p in parts]):
                assert torch.equal(a, torch.cat(ps, dim=-1 if stream
                                                else 0))


class TestSteps:
    @pytest.mark.parametrize("F", SIZES)
    @pytest.mark.parametrize("name", ["plain", "stream", "adamw"])
    def test_step_matches_jax(self, runs, F, name):
        _, out = runs
        port, want = out[F]["port"], out[F]["jax"]
        for s in range(STEPS):
            np.testing.assert_allclose(float(port[f"{name}_loss{s}"]),
                                       want[f"{name}_loss{s}"],
                                       rtol=LOSS_RTOL)
        _close_tree(port, want[name], prefix=f"{name}/")
        if name == "adamw":
            _close_tree(port, want["adamw_mu"], prefix="adamw_mu/")
            assert int(port["adamw_count"]) == want["adamw_count"] == 4 + STEPS
            assert int(port["opt_init_count"]) == 0


class TestFlatCheckpoint:
    def test_written_at_4_restores_at_4_and_at_2(self, runs):
        _, out = runs
        assert bool(out[4]["port"]["restored_equal"])
        got = out["restore_f2"]
        assert int(got["step"]) == STEPS and int(got["count"]) == 4 + STEPS
        port4 = out[4]["port"]
        for key in (k for k in port4 if k.startswith("adamw/")):
            np.testing.assert_array_equal(got["p/" + key[6:]], port4[key])
        for key in (k for k in port4 if k.startswith("adamw_mu/")):
            np.testing.assert_array_equal(got["mu/" + key[9:]], port4[key])

    @pytest.mark.parametrize("stream", [True, False])
    def test_flat_shards_restore_at_any_size(self, tmp_path, stream):
        """A global flat tree written at 4 read back as each rank's slices
        at 1, 2, 3 and 4: equal to the slices sharding at that size
        gives."""
        cfg = tt.tiny(n_layers=3)
        p = tt.init_params(0, cfg, device="cpu")
        like = tt.init_params(0, cfg, device="meta")
        shard = (ttr.fsdp_stream_shard_params if stream
                 else ttr.fsdp_shard_params)
        path = str(tmp_path / "flat")
        checkpoint.save(path, {"params": shard(p, 4)})
        for F in (1, 2, 3, 4):
            for i in range(F):
                want = ttr.fsdp_local(shard(p, F), F, i, stream=stream)
                back = checkpoint.restore(
                    path, like={"params": want}, device="cpu",
                    shardings={"params": ttr.fsdp_shardings(
                        like, F, i, stream=stream)})["params"]
                for a, b in zip(ttr.tree_leaves(back),
                                ttr.tree_leaves(want)):
                    assert torch.equal(a, b)
        back = checkpoint.restore(path, device="cpu", shardings={
            "params": ttr.fsdp_shardings(like, 2, 1, stream=stream)})
        want = ttr.fsdp_local(shard(p, 2), 2, 1, stream=stream)
        for a, b in zip(ttr.tree_leaves(back["params"]),
                        ttr.tree_leaves(want)):
            assert torch.equal(a, b)

    def test_a_slice_of_another_shape_is_refused(self, tmp_path):
        cfg = tt.tiny(n_layers=2)
        p = tt.init_params(0, cfg, device="cpu")
        like = tt.init_params(0, cfg, device="meta")
        path = str(tmp_path / "flat")
        checkpoint.save(path, {"params": ttr.fsdp_stream_shard_params(p, 2)})
        wrong = ttr.fsdp_local(ttr.fsdp_stream_shard_params(p, 3), 3, 0,
                               stream=True)
        with pytest.raises(ValueError, match="sliced"):
            checkpoint.restore(path, like={"params": wrong}, device="cpu",
                               shardings={"params": ttr.fsdp_shardings(
                                   like, 2, 0, stream=True)})


class _StubMesh:
    """The mesh surface the factories read before any collective."""

    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, dim=None):
        return self._sizes[dim]

    def get_group(self, name):
        return None


class TestRefusals:
    def test_streaming_requires_remat(self):
        cfg = tt.tiny(remat=False)
        mesh = _StubMesh(dp=1, sp=1)
        for factory in (ttr.make_fsdp_stream_train_step,
                        ttr.make_fsdp_stream_adamw_step):
            with pytest.raises(ValueError, match="remat"):
                factory(cfg, mesh)

    @pytest.mark.parametrize("axis,match", [
        ("tp", "manual fsdp with tp"), ("pp", "pp axis"),
        ("ep", "ep axis")])
    def test_axes_the_fsdp_steps_refuse(self, axis, match):
        cfg = tt.tiny()
        mesh = _StubMesh(dp=1, fsdp=2, sp=1, **{axis: 2})
        for factory in (ttr.make_fsdp_train_step,
                        ttr.make_fsdp_stream_train_step,
                        ttr.make_fsdp_stream_adamw_step):
            with pytest.raises(NotImplementedError, match=match):
                factory(cfg, mesh)

    def test_spmd_step_refuses_an_fsdp_axis(self):
        cfg = tt.tiny()
        mesh = _StubMesh(dp=1, fsdp=2, sp=1)
        for factory in (ttr.make_spmd_train_step,
                        ttr.make_adamw_spmd_train_step):
            with pytest.raises(NotImplementedError,
                               match="use make_fsdp_train_step"):
                factory(cfg, mesh)

    def test_placements_other_than_flat_storage_name_a10(self, tmp_path):
        path = str(tmp_path / "ck")
        p = tt.init_params(0, tt.tiny(), device="cpu")
        trainer.save_state(path, p, {}, 1)
        with pytest.raises(NotImplementedError, match="A10"):
            trainer.load_state(path, like_params=p, like_opt={},
                               shardings={"params": {"embed": object()}})
        with pytest.raises(NotImplementedError, match="A10"):
            checkpoint.restore(path, device="cpu", shardings=object())
