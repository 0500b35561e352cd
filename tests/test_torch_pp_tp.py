"""Parity of the port's pipelines over tp and ep (``tpushare_torch.models.
pipeline`` on pp x tp, ``moe_pipeline`` on pp x ep) with the JAX
package's, on the CPU in f32.

- pp2 x tp2 (one gloo group of 4 spawned ranks, ``tests/torch_spawn.py``),
  each rank on its slices of ``pipeline.param_specs`` (its stage's
  layers, Megatron-split over tp), gathered back by ``tp_gather``: one
  SGD step and one AdamW step (from a non-zero state) under GPipe, 1F1B
  and interleaved, against JAX's single-device steps (the reference's
  own tests hold its schedules to them, ``tests/test_pipeline.py:41,
  290``), and GPipe against JAX's ``make_pp_train_step`` on the same
  mesh shape; then ``trainer.fit`` of the 1F1B AdamW step straight and
  resumed from a checkpoint of whole leaves halfway, bit-exact
  (``tests/test_pipeline.py:340``).
- pp2 x ep2: the MoE pipeline under psum and dropless (experts split
  over ep inside each stage), SGD and AdamW, against the per-microbatch
  JAX objective (``tests/test_moe_pipeline.py``'s oracle).
- The refusals: the dense pipeline over ep (it has no experts), the MoE
  pipeline under a2a (the reference's refusal).

Tolerances: losses 1e-5 relative; parameters and moments 2e-6 abs after
a step.
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
from tpushare_torch.models import moe as tmoe
from tpushare_torch.models import moe_pipeline as tmp_
from tpushare_torch.models import pipeline as tpl
from tpushare_torch.parallel import mesh as tmesh

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
LR, WD = 0.1, 0.01
SCHEDULES = ("gpipe", "1f1b", "interleaved")
PP_TP = {"pp": 2, "tp": 2}
PP_EP = {"pp": 2, "ep": 2}
M, FIT_STEPS = 2, 4


def _opt_state(jp, seed):
    rng = np.random.default_rng(seed)
    mu = jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2
                                 ).astype(np.float32), jp)
    nu = jax.tree.map(lambda a: rng.uniform(1e-4, 4e-4, size=a.shape
                                            ).astype(np.float32), jp)
    return {"mu": mu, "nu": nu, "count": np.int32(4)}


def _close_tree(got, want, prefix, atol=PARAM_ATOL):
    flat_want = torch_spawn.flatten(jax.tree.map(np.asarray, want))
    for key, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(got[prefix + key], np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=prefix + key)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)


@functools.lru_cache(maxsize=None)
def _dense():
    jcfg = jt.tiny(remat=False, n_layers=4)
    jp = jt.init_params(jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(2).integers(0, jcfg.vocab_size, (4, 17))
    return jcfg, jp, tok


@pytest.fixture(scope="module")
def pp_tp_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_tp")
    jcfg, jp, tok = _dense()
    st = _opt_state(jp, 3)
    inputs = {"tokens": tok, "count": np.asarray(st["count"]),
              **torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"),
              **torch_spawn.flatten(st["mu"], "mu/"),
              **torch_spawn.flatten(st["nu"], "nu/")}
    for i in range(FIT_STEPS):
        inputs[f"fit{i}"] = np.random.default_rng(10 + i).integers(
            0, jcfg.vocab_size, (4, 9))
    tcfg = bridge.config_from_jax(jcfg)
    return torch_spawn.run_ranks(
        torch_spawn.pp_tp_worker, 4, tmp, inputs, "dense",
        [(s, tcfg, s) for s in SCHEDULES], PP_TP, M, LR, WD, FIT_STEPS,
        str(tmp), timeout=60.0)


@functools.lru_cache(maxsize=None)
def _jax_single():
    jcfg, jp, tok = _dense()
    sgd, loss = jax.jit(functools.partial(
        jtr.sgd_train_step, cfg=jcfg, lr=LR))(jp, jnp.asarray(tok))
    st = jax.tree.map(jnp.asarray, _opt_state(jp, 3))
    p, st, aloss = jax.jit(functools.partial(
        jtr.adamw_train_step, cfg=jcfg, lr=LR, weight_decay=WD))(
            jp, st, jnp.asarray(tok))
    return sgd, float(loss), p, st["mu"], float(aloss)


class TestDensePipelineOverTp:
    @pytest.mark.parametrize("sched", SCHEDULES)
    def test_sgd_step(self, pp_tp_run, sched):
        sgd, loss, _, _, _ = _jax_single()
        _close_loss(pp_tp_run[f"{sched}/sgd_loss"], loss)
        _close_tree(pp_tp_run, sgd, f"{sched}/sgd/")

    @pytest.mark.parametrize("sched", SCHEDULES)
    def test_adamw_step(self, pp_tp_run, sched):
        _, _, p, mu, loss = _jax_single()
        _close_loss(pp_tp_run[f"{sched}/adamw_loss"], loss)
        _close_tree(pp_tp_run, p, f"{sched}/adamw/")
        _close_tree(pp_tp_run, mu, f"{sched}/adamw_mu/")

    def test_gpipe_against_the_jax_pipeline_on_pp2_tp2(self, pp_tp_run):
        jcfg, jp, tok = _dense()
        mesh = jax_make_mesh(PP_TP, devices=jax.devices()[:4])
        step = jpl.make_pp_train_step(jcfg, mesh, n_microbatches=M, lr=LR)
        new, loss = step(shard_tree(jp, mesh, jpl.param_specs(jcfg)),
                         jnp.asarray(tok))
        _close_loss(pp_tp_run["gpipe/sgd_loss"], loss)
        _close_tree(pp_tp_run, new, "gpipe/sgd/")

    def test_fit_resumes_bit_exact(self, pp_tp_run):
        np.testing.assert_array_equal(pp_tp_run["fit_straight"],
                                      pp_tp_run["fit_resumed"])
        keys = [k for k in pp_tp_run if k.startswith("fit_straight/")]
        assert keys
        for key in keys:
            np.testing.assert_array_equal(
                pp_tp_run[key],
                pp_tp_run["fit_resumed/" + key[len("fit_straight/"):]],
                err_msg=key)

    def test_param_specs_equal_jax(self):
        jcfg = jt.tiny(n_layers=4)
        want = jpl.param_specs(jcfg)
        got = tpl.param_specs(bridge.config_from_jax(jcfg))
        for k in want["layers"]:
            assert tuple(got["layers"][k]) == tuple(want["layers"][k])
        assert tuple(got["embed"]) == tuple(want["embed"])


MOE_CASES = {"psum": {"routing": "psum"},
             "dropless": {"routing": "dropless"}}


def _moe_pair(name):
    jcfg = jmoe.tiny(remat=False, n_layers=4, **MOE_CASES[name])
    return jcfg, jmoe.init_params(jax.random.PRNGKey(0), jcfg)


@pytest.fixture(scope="module")
def pp_ep_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pp_ep")
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
    got = torch_spawn.run_ranks(torch_spawn.pp_tp_worker, 4, tmp, inputs,
                                "moe", cases, PP_EP, M, LR, WD,
                                timeout=60.0)
    return tok, got


class TestMoEPipelineOverEp:
    @pytest.mark.parametrize("name", list(MOE_CASES))
    def test_matches_the_per_microbatch_objective(self, pp_ep_run, name):
        tok, got = pp_ep_run
        jcfg, jp = _moe_pair(name)
        toks = jnp.asarray(tok)

        def loss_fn(p):
            return jnp.mean(jnp.stack([
                jmoe.lm_loss(p, toks[i * 2:(i + 1) * 2], jcfg)
                for i in range(M)]))
        loss, grads = jax.jit(jax.value_and_grad(loss_fn))(jp)
        _close_loss(got[f"{name}/sgd_loss"], loss)
        _close_tree(got, jtr._sgd_update(jp, grads, LR), f"{name}/sgd/")
        st = jax.tree.map(jnp.asarray, _opt_state(jp, 5))
        new, st = jtr.apply_adamw(jp, grads, st, lr=LR, weight_decay=WD)
        _close_loss(got[f"{name}/adamw_loss"], loss)
        _close_tree(got, new, f"{name}/adamw/")
        _close_tree(got, st["mu"], f"{name}/adamw_mu/")


class _StubMesh:
    def __init__(self, **sizes):
        self.mesh_dim_names = tuple(sizes)
        self._sizes = list(sizes.values())

    def size(self, dim=None):
        return self._sizes[dim]

    def get_group(self, name):
        return None


class TestRefusals:
    def test_dense_pipeline_over_ep(self):
        cfg = bridge.config_from_jax(jt.tiny(remat=False))
        with pytest.raises(NotImplementedError, match="no experts"):
            tpl.make_pp_train_step(cfg, _StubMesh(pp=2, ep=2),
                                   n_microbatches=2)

    def test_moe_pipeline_refuses_a2a_and_sp(self):
        cfg = tmoe.tiny(remat=False, routing="a2a", capacity_factor=2.0)
        p = tmoe.init_params(0, cfg, device="cpu")
        tok = torch.zeros((2, 8), dtype=torch.long)
        with pytest.raises(NotImplementedError, match="a2a"):
            tmp_.moe_pipelined_lm_loss(p, tok, tok, cfg, pp_group=None,
                                       n_microbatches=2)
        with pytest.raises(NotImplementedError, match="pp x ep x tp x dp"):
            tmp_.make_moe_pp_train_step(tmoe.tiny(), _StubMesh(sp=2),
                                        n_microbatches=2)

    def test_moe_pipeline_specs_split_layers_over_pp(self):
        specs = tmp_.param_specs(tmoe.tiny())
        assert tuple(specs["layers"]["w_gate"]) == ("pp", "ep", None, "tp")
        assert tuple(specs["layers"]["router"]) == ("pp", None, None)
        assert tmesh.data_axes(True) == ("dp", "ep", "sp")


class TestCheckpointBlocks:
    def test_a_first_dimension_block_is_writable(self, tmp_path):
        """A stage's block of a layer stack (a split of the first
        dimension, contiguous in the file) reads back as a tensor of its
        own: an optimizer updates it in place. A view of the read-only
        map would fault on the write."""
        from tpushare_torch.utils import checkpoint
        tree = {"layers": {"w": torch.arange(24.0).reshape(4, 6)}}
        path = str(tmp_path / "ck")
        checkpoint.save(path, tree)
        sizes = {ax: 1 for ax in tmesh.MESH_AXES}
        sizes["pp"] = 2
        specs = {"layers": {"w": tpl.P("pp", None)}}
        for stage in range(2):
            coords = {ax: 0 for ax in tmesh.MESH_AXES}
            coords["pp"] = stage
            got = checkpoint.restore(
                path, like={"layers": {"w": torch.empty(2, 6)}},
                shardings=checkpoint.shardings_at(specs, sizes, coords),
                device="cpu")["layers"]["w"]
            assert torch.equal(got, tree["layers"]["w"][2 * stage:
                                                        2 * stage + 2])
            got.mul_(2.0)
            assert torch.equal(got, 2 * tree["layers"]["w"][2 * stage:
                                                            2 * stage + 2])
