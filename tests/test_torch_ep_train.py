"""Parity of the port's MoE training over expert and tensor parallelism
(``tpushare_torch.models.moe``'s SPMD steps on an ep x tp mesh) with the
JAX package's, on the CPU in f32.

- ``moe.make_spmd_train_step`` and ``make_adamw_spmd_train_step`` on
  ep2 x tp2, one gloo group of 4 spawned ranks (``tests/torch_spawn.py``),
  each rank on its ``param_specs`` slices (2 of 4 experts, half of each
  expert's hidden and of the attention heads), one SGD step and one
  AdamW step from a non-zero state, the slices gathered by
  ``tp_gather``, under every routing the reference trains over ep
  (``tests/test_moe.py``: ``TestSpmd``, ``TestCapacityDispatch``,
  ``TestA2ARouting``, ``TestDroplessRouting``, ``TestMoEAdamW``,
  ``TestExpertChoice``): psum with dense dispatch and at capacity 1.5,
  a2a at capacity E / top_k (ep a data axis: the batch split over ep),
  dropless and expert_choice. Held against the JAX steps on the same
  mesh shape of virtual CPU devices; the replicated leaves (embeddings,
  norms, router) bit-equal across every tp group.
- ``trainer.fit`` of the ep2 x tp2 AdamW step resumes bit-exact from a
  checkpoint of whole leaves; that state restores onto tp1, tp2 and
  ep2 x tp2 slices through ``load_state(shardings=)``, equal to the
  slices of the whole tree.

Tolerances: losses within 1e-5 relative; parameters and moments within
2e-6 abs after a step (f32 gradients summed in other orders, by lr).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import moe as jm
from tpushare.models import training as jtr
from tpushare.parallel import shard_tree as jax_shard_tree
from tpushare.parallel.mesh import make_mesh as jax_make_mesh

import torch_spawn
from tpushare_torch.models import bridge, trainer
from tpushare_torch.models import moe as tm
from tpushare_torch.models import training as ttr
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import sharding
from tpushare_torch.utils import checkpoint

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
LR, WD = 0.1, 0.01
MESH = {"ep": 2, "tp": 2}
# name: config overrides (tiny: 4 experts, top-2)
ROUTINGS = {"psum": {"routing": "psum"},
            "psum_capacity": {"routing": "psum", "capacity_factor": 1.5},
            "a2a": {"routing": "a2a", "capacity_factor": 2.0},
            "dropless": {"routing": "dropless"},
            "expert_choice": {"routing": "expert_choice"}}


def _pair(name, seed=0):
    jcfg = jm.tiny(remat=True, aux_loss_weight=0.1, **ROUTINGS[name])
    return jcfg, jm.init_params(jax.random.PRNGKey(seed), jcfg)


def _opt_state(jp, seed):
    rng = np.random.default_rng(seed)
    return {"mu": jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2
                                          ).astype(np.float32), jp),
            "nu": jax.tree.map(lambda a: rng.uniform(
                1e-4, 4e-4, size=a.shape).astype(np.float32), jp),
            "count": np.int32(4)}


def _close_tree(got, want, prefix, atol=PARAM_ATOL):
    flat_want = torch_spawn.flatten(jax.tree.map(np.asarray, want))
    for key, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(got[prefix + key], np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=prefix + key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_train")
    tok = np.random.default_rng(3).integers(0, 256, (4, 17))
    inputs, cases = {"tokens": tok, "count": np.int32(4)}, []
    for name in ROUTINGS:
        jcfg, jp = _pair(name)
        st = _opt_state(jp, 5)
        inputs.update(**torch_spawn.flatten(jax.tree.map(np.asarray, jp),
                                            f"{name}/p/"),
                      **torch_spawn.flatten(st["mu"], f"{name}/mu/"),
                      **torch_spawn.flatten(st["nu"], f"{name}/nu/"))
        cases.append((name, bridge.moe_config_from_jax(jcfg)))
    got = torch_spawn.run_ranks(torch_spawn.moe_tp_train_worker, 4, tmp,
                                inputs, cases, MESH, LR, WD, timeout=60.0)
    return tok, got


def _jax_mesh():
    return jax_make_mesh(MESH, devices=jax.devices()[:4])


class TestMoEOverEpTp:
    @pytest.mark.parametrize("name", list(ROUTINGS))
    def test_sgd_step(self, runs, name):
        tok, got = runs
        jcfg, jp = _pair(name)
        mesh = _jax_mesh()
        step = jm.make_spmd_train_step(jcfg, mesh, lr=LR)
        new, loss = step(jax_shard_tree(jp, mesh, jm.param_specs(jcfg)),
                         jnp.asarray(tok))
        np.testing.assert_allclose(float(got[f"{name}/sgd_loss"]),
                                   float(loss), rtol=LOSS_RTOL)
        _close_tree(got, new, f"{name}/sgd/")
        keys = got[f"{name}/sgd_digest_keys"]
        digs = got[f"{name}/sgd_digests"]
        by = {}
        for k, d in zip(keys, digs):
            by.setdefault(str(k), set()).add(str(d))
        assert len(by) == 2 and all(len(v) == 1 for v in by.values()), by

    @pytest.mark.parametrize("name", list(ROUTINGS))
    def test_adamw_step(self, runs, name):
        tok, got = runs
        jcfg, jp = _pair(name)
        mesh = _jax_mesh()
        specs = jm.param_specs(jcfg)
        step, _ = jm.make_adamw_spmd_train_step(jcfg, mesh, lr=LR,
                                                weight_decay=WD)
        st = jax_shard_tree(jax.tree.map(jnp.asarray, _opt_state(jp, 5)),
                            mesh, jtr.opt_state_specs(specs))
        new, st, loss = step(jax_shard_tree(jp, mesh, specs), st,
                             jnp.asarray(tok))
        np.testing.assert_allclose(float(got[f"{name}/adamw_loss"]),
                                   float(loss), rtol=LOSS_RTOL)
        _close_tree(got, new, f"{name}/adamw/")
        _close_tree(got, st["mu"], f"{name}/adamw_mu/")

    def test_a2a_shards_the_batch_over_ep(self):
        """Under a2a the tokens' rows split over (dp, ep); under the
        other routings they stay whole on every ep rank."""
        mesh = tmesh.ServingMesh({"ep": 2, "tp": 2}, ["cpu"] * 4)
        tok = torch.arange(4 * 5).reshape(4, 5)
        for r, rows in ((0, [0, 1]), (1, [0, 1]), (2, [2, 3]),
                        (3, [2, 3])):
            mesh.rank = r
            assert torch.equal(tm.shard_tokens(tok, mesh, ep=True),
                               tok[rows])
            assert torch.equal(tm.shard_tokens(tok, mesh), tok)


@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ep_fit")
    jcfg, jp = _pair("psum_capacity", seed=1)
    inputs = {f"tokens{i}": np.random.default_rng(70 + i).integers(
        0, 256, (2, 9)) for i in range(4)}
    inputs.update(torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"))
    tcfg = bridge.moe_config_from_jax(jcfg)
    got = torch_spawn.run_ranks(torch_spawn.tp_fit_worker, 4, tmp, inputs,
                                "moe", tcfg, MESH, 0.01, 4, str(tmp),
                                timeout=60.0)
    return tcfg, got


class TestCheckpoints:
    def test_fit_resumes_bit_exact(self, fit_run):
        _, got = fit_run
        assert list(got["restored_equal"]) == [True] * 4
        np.testing.assert_array_equal(got["straight_losses"],
                                      got["resumed_losses"])
        for key in [k for k in got if k.startswith("straight/")]:
            np.testing.assert_array_equal(
                got[key], got["resumed/" + key[len("straight/"):]],
                err_msg=key)

    @pytest.mark.parametrize("target", [{}, {"tp": 2},
                                        {"ep": 2, "tp": 2}])
    def test_restores_onto_any_ep_tp_shape(self, fit_run, target):
        tcfg, got = fit_run
        path = str(got["ckpt"])
        whole = checkpoint.restore(path, device="cpu")
        specs = tm.param_specs(tcfg)
        ospecs = ttr.opt_state_specs(specs)
        sizes = {ax: target.get(ax, 1) for ax in tmesh.MESH_AXES}
        n = int(np.prod(list(sizes.values())))
        for r in range(n):
            coords = tmesh.ServingMesh(target, ["cpu"] * n).coords(r)

            def cut(tree, sp):
                return sharding.walk_specs(
                    tree, sp, lambda t, s: sharding.shard_leaf(
                        t, s, sizes, coords))
            like_p = cut(whole["params"], specs)
            like_o = cut(whole["opt_state"], ospecs)
            p, o, step = trainer.load_state(
                path, like_params=like_p, like_opt=like_o,
                shardings={"params": checkpoint.shardings_at(
                    specs, sizes, coords),
                    "opt_state": checkpoint.shardings_at(
                        ospecs, sizes, coords)})
            assert step == 2
            for a, b in zip(ttr.tree_leaves({"p": p, "o": o}),
                            ttr.tree_leaves({"p": like_p, "o": like_o})):
                assert torch.equal(a, b)
            E = whole["params"]["layers"]["w_gate"].shape[1]
            assert p["layers"]["w_gate"].shape[1] == E // sizes["ep"]
            assert o["mu"]["layers"]["w_down"].shape[2] == \
                whole["params"]["layers"]["w_down"].shape[2] // sizes["tp"]


class TestRefusals:
    def test_ep_must_divide_the_experts(self):
        mesh = tmesh.ServingMesh({"ep": 2}, ["cpu"] * 2)
        with pytest.raises(ValueError, match="divide"):
            tm.make_spmd_train_step(tm.tiny(n_experts=3), mesh)

    def test_a2a_requires_capacity(self):
        """The reference's refusal, from the first forward over ep."""
        cfg = tm.tiny(routing="a2a")
        layer = {k: v[0] for k, v in tm.init_params(
            0, cfg, device="cpu")["layers"].items()}
        h = torch.zeros((1, 4, cfg.d_model))
        with pytest.raises(ValueError, match="capacity_factor"):
            tm._moe_ffn(h, layer, cfg, ep=object())
