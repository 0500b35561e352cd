"""Parity of the port's training under tensor parallelism
(``tpushare_torch.models.training`` over a mesh with tp, ``transformer``'s
"f" and "g" operators) with the JAX package's, on the CPU in f32.

- ``make_spmd_train_step`` and ``make_adamw_spmd_train_step`` on tp2,
  dp2 x tp2 and sp2 x tp2 (ring attention, and Ulysses with
  ``sp_impl="a2a"``: 2 query and 1 kv heads a rank, the kv head
  broadcast over sp), each rank on its ``param_specs`` slices, in gloo
  groups of spawned ranks (``tests/torch_spawn.py``), two steps each from
  the same params (AdamW from a non-zero state), the slices gathered by
  ``tp_gather``: against the JAX steps on the same mesh shape of virtual
  CPU devices (``make_spmd_train_step`` / ``make_adamw_spmd_train_step``
  under shard_map; the JAX AdamW step has no ``sp_impl``, so the a2a
  case's AdamW is held to the ring's JAX step, the same function). The
  replicated leaves are bit-equal across every tp group (their digests),
  and each rank holds moments for its slices only.
- A planted defect: "g" whose backward all-reduces its input gradient
  (``torch.distributed.nn``'s derivative of a sum) fails the tp2 test.
- ``trainer.fit`` of the tp2 AdamW step resumes bit-exact from a
  checkpoint of whole leaves (``SpmdStep.save_state``), restored onto
  the ranks' slices; and a tp2 AdamW state, saved whole, restores onto
  tp1, tp2 and ep2 x tp2 slices through ``load_state(shardings=)``,
  equal to the gathered tree's slices.
- The refusals kept: fsdp x tp (the reference's message), the dense step
  over ep or pp.

Tolerances: losses within 1e-5 relative; parameters and moments within
2e-6 abs after two steps (f32 gradients summed in other orders, by lr).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import training as jtr
from tpushare.models import transformer as jt
from tpushare.parallel import shard_tree as jax_shard_tree
from tpushare.parallel.mesh import make_mesh as jax_make_mesh

import torch_spawn
from tpushare_torch.models import bridge, trainer
from tpushare_torch.models import training as ttr
from tpushare_torch.models import transformer as tt
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.parallel import sharding
from tpushare_torch.utils import checkpoint

torch.set_num_threads(1)

LOSS_RTOL = 1e-5
PARAM_ATOL = 2e-6
LR, WD, STEPS = 0.05, 0.01, 2
GEMMA2 = {"norm_offset": 1.0, "embed_scale": True, "act": "gelu",
          "sliding_window": 6, "alternate_sliding": True,
          "attn_softcap": 20.0, "final_softcap": 15.0, "post_norms": True,
          "attn_scale": 0.15}
# name: (mesh, sp_impl)
MESHES = {"tp2": ({"tp": 2}, "ring"),
          "dp2_tp2": ({"dp": 2, "tp": 2}, "ring"),
          "sp2_tp2": ({"sp": 2, "tp": 2}, "ring"),
          "sp2_tp2_a2a": ({"sp": 2, "tp": 2}, "a2a")}


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


def _tokens(seed, B, S, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (B, S + 1))


def _inputs(jp, tok, state):
    return {"tokens": tok, "count": np.asarray(state["count"]),
            **torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"),
            **torch_spawn.flatten(state["mu"], "mu/"),
            **torch_spawn.flatten(state["nu"], "nu/")}


def _close_tree(got, want, prefix, atol=PARAM_ATOL):
    flat_want = torch_spawn.flatten(jax.tree.map(np.asarray, want))
    assert sorted(k[len(prefix):] for k in got if k.startswith(prefix)
                  and "digest" not in k) == sorted(flat_want)
    for key, w in flat_want.items():
        np.testing.assert_allclose(np.asarray(got[prefix + key], np.float32),
                                   np.asarray(w, np.float32), rtol=0,
                                   atol=atol, err_msg=prefix + key)


def _close_loss(got, want):
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL,
                               atol=0)


def _digests_agree(got, prefix):
    """Every tp group's ranks hold bit-equal replicated leaves."""
    keys, digs = got[prefix + "digest_keys"], got[prefix + "digests"]
    assert len(keys) >= 2
    by = {}
    for k, d in zip(keys, digs):
        by.setdefault(str(k), set()).add(str(d))
    assert all(len(v) == 1 for v in by.values()), by


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_train")
    jcfg, jp, tcfg = _pair()
    tok = _tokens(40, 2, 16, jcfg.vocab_size)
    state = _opt_state(jp, 4)
    out = {}
    for name, (sizes, sp_impl) in MESHES.items():
        world = int(np.prod(list(sizes.values())))
        out[name] = torch_spawn.run_ranks(
            torch_spawn.tp_train_worker, world, tmp,
            _inputs(jp, tok, state), tcfg, sizes, LR, STEPS, WD,
            {"sp_impl": sp_impl}, timeout=60.0)
    return jcfg, jp, tok, state, out


@functools.lru_cache(maxsize=None)
def _jax_mesh(name):
    sizes = MESHES[name][0]
    n = int(np.prod(list(sizes.values())))
    return jax_make_mesh(sizes, devices=jax.devices()[:n])


def _jax_sgd(jcfg, jp, tok, name):
    mesh = _jax_mesh(name)
    step = jtr.make_spmd_train_step(jcfg, mesh, lr=LR,
                                    sp_impl=MESHES[name][1])
    jp = jax_shard_tree(jp, mesh, jt.param_specs(jcfg))
    losses = []
    for _ in range(STEPS):
        jp, loss = step(jp, jnp.asarray(tok))
        losses.append(loss)
    return jp, losses


class TestDenseTp:
    @pytest.mark.parametrize("name", list(MESHES))
    def test_sgd_steps(self, runs, name):
        jcfg, jp, tok, _, out = runs
        got = out[name]
        want, losses = _jax_sgd(jcfg, jp, tok, name)
        for s in range(STEPS):
            _close_loss(got[f"sgd_loss{s}"], losses[s])
        _close_tree(got, want, "sgd/")
        _digests_agree(got, "sgd_")

    @pytest.mark.parametrize("name", list(MESHES))
    def test_adamw_steps(self, runs, name):
        jcfg, jp, tok, state, out = runs
        got = out[name]
        mesh = _jax_mesh(name)
        step = jtr.make_adamw_spmd_train_step(jcfg, mesh, lr=LR,
                                              weight_decay=WD)
        specs = jt.param_specs(jcfg)
        jp = jax_shard_tree(jp, mesh, specs)
        js = jax_shard_tree(jax.tree.map(jnp.asarray, state), mesh,
                            jtr.opt_state_specs(specs))
        for s in range(STEPS):
            jp, js, loss = step(jp, js, jnp.asarray(tok))
            _close_loss(got[f"adamw_loss{s}"], loss)
        _close_tree(got, jp, "adamw/")
        _close_tree(got, js["mu"], "adamw_mu/")
        _close_tree(got, js["nu"], "adamw_nu/", atol=1e-8)
        assert int(got["adamw_count"]) == int(js["count"]) == 4 + STEPS
        _digests_agree(got, "adamw_")

    @pytest.mark.parametrize("name", list(MESHES))
    def test_moments_are_the_ranks_slices(self, runs, name):
        """Each rank holds f32 moments of its own slices: the tp-split
        leaves' share of them and the replicated leaves whole."""
        jcfg, jp, _, _, out = runs
        sizes = MESHES[name][0]
        tp = sizes.get("tp", 1)
        specs = tt.param_specs(bridge.config_from_jax(jcfg))
        flat_p = torch_spawn.flatten(jax.tree.map(np.asarray, jp))
        flat_s = _spec_flat(specs)
        want = 0
        for key, a in flat_p.items():
            split = sharding.spec_axes(flat_s[key])
            want += 2 * 4 * a.size // (tp if "tp" in split else 1)
        assert list(out[name]["moment_bytes"]) == [want] * int(
            np.prod(list(sizes.values())))


def _spec_flat(specs, prefix=""):
    out = {}
    for k, v in specs.items():
        if isinstance(v, dict):
            out.update(_spec_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


class TestPlantedDefect:
    def test_g_with_an_all_reduce_in_its_backward_fails(self, runs,
                                                        tmp_path):
        """The tp2 SGD test's gates with "g"'s backward all-reducing its
        input gradient: the replicated leaves' gradients come out tp
        times too large, and the gathered params leave the JAX step's
        tolerance."""
        jcfg, jp, tok, state, _ = runs
        got = torch_spawn.run_ranks(
            torch_spawn.tp_train_worker, 2, tmp_path,
            _inputs(jp, tok, state), bridge.config_from_jax(jcfg),
            {"tp": 2}, LR, STEPS, WD,
            {"sp_impl": "ring", "fault": "g_allreduce"}, timeout=60.0)
        want, _ = _jax_sgd(jcfg, jp, tok, "tp2")
        with pytest.raises(AssertionError):
            _close_tree(got, want, "sgd/")


@pytest.fixture(scope="module")
def fit_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("tp_fit")
    jcfg, jp, tcfg = _pair(1)
    inputs = {f"tokens{i}": _tokens(60 + i, 2, 8, jcfg.vocab_size)
              for i in range(4)}
    inputs.update(torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"))
    got = torch_spawn.run_ranks(torch_spawn.tp_fit_worker, 2, tmp, inputs,
                                "dense", tcfg, {"tp": 2}, LR, 4, str(tmp),
                                timeout=60.0)
    return jcfg, jp, tcfg, got


class TestCheckpoints:
    def test_fit_resumes_bit_exact(self, fit_run):
        _, _, _, got = fit_run
        assert list(got["restored_equal"]) == [True, True]
        np.testing.assert_array_equal(got["straight_losses"],
                                      got["resumed_losses"])
        for key in [k for k in got if k.startswith("straight/")]:
            np.testing.assert_array_equal(
                got[key], got["resumed/" + key[len("straight/"):]],
                err_msg=key)

    @pytest.mark.parametrize("target", [{}, {"tp": 2},
                                        {"ep": 2, "tp": 2}])
    def test_whole_checkpoint_restores_onto_any_tp_shape(self, fit_run,
                                                         target):
        """The tp2 fit's checkpoint holds whole leaves; every rank of
        tp1, tp2 and ep2 x tp2 reads its own slices of params and
        moments back through ``load_state(shardings=)``, equal to the
        slices of the whole tree."""
        _, _, tcfg, got = fit_run
        path = str(got["ckpt"])
        whole = checkpoint.restore(path, device="cpu")
        specs = tt.param_specs(tcfg)
        ospecs = ttr.opt_state_specs(specs)
        sizes = {ax: target.get(ax, 1) for ax in tmesh.MESH_AXES}
        n = int(np.prod(list(sizes.values())))
        for r in range(n):
            mesh = tmesh.ServingMesh(target, ["cpu"] * n)
            coords = mesh.coords(r)
            like_p = sharding.walk_specs(
                whole["params"], specs, lambda t, sp: sharding.shard_leaf(
                    t, sp, sizes, coords))
            like_o = sharding.walk_specs(
                whole["opt_state"], ospecs,
                lambda t, sp: sharding.shard_leaf(t, sp, sizes, coords))
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
            if target.get("tp"):
                assert p["layers"]["wq"].shape[-1] == \
                    whole["params"]["layers"]["wq"].shape[-1] // 2


    def test_save_gathers_one_leaf_at_a_time(self, tmp_path):
        """``save_sharded`` of a tp2 AdamW state: each split leaf is
        gathered just before rank 0 writes it and is gone before the next
        gather, on every rank (no rank holds two whole leaves); the file
        holds the whole state ``tp_gather`` gives."""
        jcfg, jp, tcfg = _pair(2)
        state = _opt_state(jp, 3)
        path = str(tmp_path / "state")
        got = torch_spawn.run_ranks(
            torch_spawn.tp_save_worker, 2, tmp_path,
            _inputs(jp, _tokens(0, 1, 4, jcfg.vocab_size), state), tcfg,
            {"tp": 2}, path, timeout=60.0)
        specs = tt.param_specs(tcfg)
        n_split = sum(bool(sharding.spec_axes(sp)) for sp in
                      ttr.tree_leaves(ttr.opt_state_specs(specs))
                      ) + sum(bool(sharding.spec_axes(sp))
                              for sp in ttr.tree_leaves(specs))
        events = str(got["events"])
        assert n_split > 0 and list(got["gathers"]) == [n_split] * 2
        assert "gg" not in events and events.count("g") == n_split
        assert list(got["most_alive"]) == [0, 0]
        saved = torch_spawn.flatten(checkpoint.restore(path, device="cpu"))
        whole = {k[len("whole/"):]: v for k, v in got.items()
                 if k.startswith("whole/")}
        assert sorted(saved) == sorted(list(whole) + ["step"])
        for key, w in whole.items():
            np.testing.assert_array_equal(saved[key], w, err_msg=key)


class TestRefusals:
    def test_fsdp_with_tp_keeps_the_reference_message(self):
        mesh = tmesh.ServingMesh({"fsdp": 2, "tp": 2}, ["cpu"] * 4)
        for factory in (ttr.make_spmd_train_step,
                        ttr.make_adamw_spmd_train_step):
            with pytest.raises(NotImplementedError,
                               match="use make_fsdp_train_step"):
                factory(tt.tiny(), mesh)

    @pytest.mark.parametrize("axis", ["ep", "pp"])
    def test_dense_step_refuses_ep_and_pp(self, axis):
        mesh = tmesh.ServingMesh({axis: 2, "tp": 2}, ["cpu"] * 4)
        with pytest.raises(NotImplementedError, match=f"{axis} axis not used"):
            ttr.make_spmd_train_step(tt.tiny(), mesh)


def test_part_f_tool_on_the_host():
    """tools/multichip.py's part F (``--part train``) end to end on the
    CPU at the tiny size: the one-card twins, then the tp=2, ep=2 and
    four-rank groups as processes, every gate held (the gradient slices
    against the twins' within GRAD_REL_L2_TOL, the losses, the digests,
    the moments a rank holds)."""
    import json
    import os
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.tools.multichip", "--device",
         "cpu", "--tiny", "--part", "train"], cwd=root, env=env,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["part"] == "F" and rec["failures"] == []
    for part in ("f1", "f2_psum", "f2_a2a", "f3_sp", "f3_pp"):
        assert rec[part]["grad_rel_l2_max"] < 1e-4, (part, rec[part])
    adamw = rec["ranks"]["f1"][0]["adamw"]
    assert adamw["slice_params"] < adamw["whole_params"]
