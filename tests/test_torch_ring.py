"""Parity of the port's partial pass, attention gradient and ring
attention with the JAX package, on the CPU in f32.

- ``flash_attention_partial_plain`` (and the wrapper on CPU tensors)
  against JAX ``partial_reference``: chunks before, straddling and
  wholly after the queries, window, softcap, GQA.
- ``flash_attention_bwd_plain``, over one chunk and split into chunks,
  and both autograd Functions (``FlashAttentionFn`` behind
  ``flash_attention``; ``RingAttentionFn``) against ``jax.vjp`` of
  ``mha_reference`` / ``ring_attention_sharded`` — the JAX package has
  no attention gradient of its own, so the oracle is JAX autodiff of
  its reference paths.
- ``ring_attention_sharded`` over real gloo groups of 2 and 4 spawned
  processes (``tests/torch_spawn.py``; ~10 s each) against JAX
  ``ring_attention_sharded`` (dense) on the conftest's 8-device CPU
  mesh, and against the port's single-process ``flash_attention``.
- ``ulysses_attention_sharded`` (``parallel/ulysses.py``) over gloo
  groups of 2 and 4 against JAX ``ulysses_attention_sharded``, forward
  and gradient (kv heads the group does not divide repeated up, a
  window with a softcap, a scale); and the dense LM's SGD and AdamW
  steps over dp1 x sp4 and dp2 x sp2 with ``sp_impl="a2a"`` against the
  JAX ``make_spmd_train_step(sp_impl="a2a")`` and the port's
  single-process steps.

Tolerance: 2e-5 abs, 1e-5 rel on f32 values and gradients — the two
libraries sum the same products in other orders, nothing else.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.ops.attention import NEG_INF
from tpushare.ops.attention import mha_reference as jax_mha
from tpushare.ops.flash_attention import partial_reference
from tpushare.parallel.mesh import make_mesh as jax_make_mesh
from tpushare.parallel.ring_attention import (
    ring_attention_sharded as jax_ring_sharded,
)
from tpushare.parallel.ulysses import (
    ulysses_attention_sharded as jax_ulysses_sharded,
)

import torch_spawn

tfa = importlib.import_module("tpushare_torch.ops.flash_attention")
tring = importlib.import_module("tpushare_torch.parallel.ring_attention")

ATOL, RTOL = 2e-5, 1e-5


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=RTOL, atol=atol)


def _qkv(seed, B, Sq, Sk, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Sk, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, Sq, H, D)).astype(np.float32))


def _t(*arrays, grad=False):
    return [torch.tensor(a, requires_grad=grad) for a in arrays]


# (name, H, Hkv, Sq, Sk, q_offset, k_offset, window, softcap)
PARTIAL_CASES = [
    ("before", 4, 2, 16, 16, 32, 0, None, None),
    ("straddle", 4, 2, 16, 24, 8, 0, None, None),
    ("after", 4, 2, 16, 16, 0, 32, None, None),
    ("window", 4, 2, 16, 24, 40, 16, 12, None),
    ("window_past_chunk", 4, 1, 8, 8, 40, 0, 10, None),
    ("softcap", 4, 1, 16, 24, 8, 0, None, 5.0),
    ("mha_window_softcap", 2, 2, 12, 20, 10, 4, 6, 3.0),
]


class TestPartialPlain:
    @pytest.mark.parametrize("name,H,Hkv,Sq,Sk,qo,ko,window,cap",
                             PARTIAL_CASES)
    def test_matches_partial_reference(self, name, H, Hkv, Sq, Sk, qo, ko,
                                       window, cap):
        q, k, v, _ = _qkv(1, 2, Sq, Sk, H, Hkv, 32)
        kw = dict(q_offset=qo, k_offset=ko, window=window, attn_softcap=cap)
        want = partial_reference(q, k, v, **kw)
        for fn in (tfa.flash_attention_partial_plain,
                   tfa.flash_attention_partial):
            got = fn(*_t(q, k, v), **kw)
            for g, w in zip(got, want):
                assert g.dtype == torch.float32 and g.shape == w.shape
                _close(g, w)

    def test_wholly_future_chunk_is_empty(self):
        q, k, v, _ = _qkv(2, 1, 8, 8, 4, 2, 32)
        acc, m, l = tfa.flash_attention_partial_plain(
            *_t(q, k, v), q_offset=0, k_offset=8)
        assert float(acc.abs().max()) == 0.0 and float(l.max()) == 0.0
        assert bool((m == NEG_INF).all())
        assert bool(torch.isfinite(acc).all())

    def test_merged_chunks_equal_whole_attention(self):
        """The ring's merge helper over 3 chunks (one wholly future)
        equals attention over the whole key range."""
        q, k, v, _ = _qkv(3, 2, 8, 24, 4, 2, 32)
        tq, tk, tv = _t(q, k, v)
        state = tring.empty_state(tq)
        for c0 in (0, 8, 16):
            state = tring.merge_partial(state, tfa.flash_attention_partial(
                tq, tk[:, c0:c0 + 8], tv[:, c0:c0 + 8], q_offset=8,
                k_offset=c0, window=7, attn_softcap=4.0))
        out, _ = tring.finish(state)
        _close(out, jax_mha(q, k, v, q_offset=8, window=7, attn_softcap=4.0))


def _lse_dsum(q, k, v, do, kw):
    """Final log-sum-exp and rowsum(do * out) of attention over all of k."""
    acc, m, l = tfa.flash_attention_partial_plain(*_t(q, k, v), **kw)
    out = acc / l.transpose(1, 2)[..., None]
    return m + torch.log(l), tfa.softmax_dsum(torch.tensor(do), out)


GRAD_CASES = [(4, 2, None, None), (4, 1, 6, None), (4, 2, None, 5.0),
              (2, 2, 5, 3.0)]


class TestGradient:
    @pytest.mark.parametrize("H,Hkv,window,cap", GRAD_CASES)
    def test_bwd_plain_matches_jax_grad(self, H, Hkv, window, cap):
        """One chunk holding every key, and the same keys split into 3
        chunks at their k_offsets (dq summed, dk/dv per chunk)."""
        q, k, v, do = _qkv(4, 2, 12, 24, H, Hkv, 32)
        kw = dict(q_offset=12, window=window, attn_softcap=cap)
        _, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, **kw), q, k, v)
        want = vjp(do)
        lse, dsum = _lse_dsum(q, k, v, do, kw)
        for fn in (tfa.flash_attention_bwd_plain, tfa.flash_attention_bwd):
            got = fn(*_t(q, k, v, do), lse, dsum, **kw)
            for g, w in zip(got, want):
                _close(g, w)
        dq = 0
        dk, dv = [], []
        for c0 in (0, 8, 16):
            g = tfa.flash_attention_bwd_plain(
                *_t(q, k[:, c0:c0 + 8], v[:, c0:c0 + 8], do), lse, dsum,
                k_offset=c0, **kw)
            dq = dq + g[0]
            dk.append(g[1])
            dv.append(g[2])
        _close(dq, want[0])
        _close(torch.cat(dk, 1), want[1])
        _close(torch.cat(dv, 1), want[2])

    @pytest.mark.parametrize("H,Hkv,window,cap", GRAD_CASES)
    @pytest.mark.parametrize("q_offset", [0, 6])
    def test_flash_attention_fn_matches_jax_grad(self, H, Hkv, window, cap,
                                                 q_offset):
        q, k, v, do = _qkv(5, 2, 10, 10 + q_offset, H, Hkv, 32)
        kw = dict(q_offset=q_offset, window=window, attn_softcap=cap)
        out, vjp = jax.vjp(lambda a, b, c: jax_mha(a, b, c, **kw), q, k, v)
        tq, tk, tv = _t(q, k, v, grad=True)
        got = tfa.flash_attention(tq, tk, tv, **kw)
        assert got.grad_fn is not None and \
            type(got.grad_fn).__name__ == "FlashAttentionFnBackward"
        _close(got.detach(), out)
        got.backward(torch.tensor(do))
        for t, w in zip((tq, tk, tv), vjp(do)):
            _close(t.grad, w)

    def test_kernel_wrappers_refuse_before_any_build(self):
        """Off the CPU a wrapper launches or raises; its checks run
        before any kernel is built."""
        def meta(*shape, dtype=torch.float32):
            return torch.empty(shape, dtype=dtype, device="meta")
        q = meta(1, 4, 2, 128)
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention_partial(*[meta(1, 4, 2, 32)] * 3)
        with pytest.raises(TypeError, match="Python ints"):
            tfa.flash_attention_partial(q, q, q, k_offset=1.5)
        lse = meta(1, 2, 4)
        with pytest.raises(ValueError, match="dout must match q"):
            tfa.flash_attention_bwd(q, q, q, meta(1, 4, 2, 128,
                                                  dtype=torch.bfloat16),
                                    lse, lse)
        with pytest.raises(ValueError, match="dsum must be f32"):
            tfa.flash_attention_bwd(q, q, q, q, lse, meta(1, 4, 2))

    def test_no_grad_call_skips_the_function(self):
        q, k, v, _ = _qkv(6, 1, 6, 6, 2, 1, 32)
        with torch.no_grad():
            out = tfa.flash_attention(*_t(q, k, v, grad=True))
        assert out.grad_fn is None


RING_CASES = [
    ("gqa", 4, 2, dict()),
    ("window_softcap", 4, 1, dict(window=5, attn_softcap=4.0)),
    ("dense_scale", 2, 2, dict(impl="dense", scale=0.2, window=9)),
]


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory):
    """One spawned gloo group per world size (2, 4), each running every
    ring case."""
    tmp = tmp_path_factory.mktemp("ring")
    inputs, out = {}, {}
    for name, H, Hkv, _ in RING_CASES:
        for x, a in zip(("q", "k", "v", "do"),
                        _qkv(7, 2, 16, 16, H, Hkv, 32)):
            inputs[f"{name}_{x}"] = a
    cases = [(name, kw) for name, _, _, kw in RING_CASES]
    for world in (2, 4):
        out[world] = torch_spawn.run_ranks(torch_spawn.ring_worker, world,
                                           tmp, inputs, cases)
    return inputs, out


class TestRingAttention:
    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("name", [c[0] for c in RING_CASES])
    def test_matches_jax_ring_and_single_process(self, ring_runs, world,
                                                 name):
        inputs, runs = ring_runs
        got = runs[world]
        kw = dict(next(c[3] for c in RING_CASES if c[0] == name))
        kw.pop("impl", None)
        q, k, v, do = (inputs[f"{name}_{x}"] for x in ("q", "k", "v", "do"))
        mesh = jax_make_mesh({"sp": world}, devices=jax.devices()[:world])

        @jax.jit
        def fwd_bwd(a, b, c, d):
            out, vjp = jax.vjp(lambda a, b, c: jax_ring_sharded(
                a, b, c, mesh=mesh, impl="dense", **kw), a, b, c)
            return (out,) + tuple(vjp(d))
        want = fwd_bwd(q, k, v, jnp.asarray(do))
        for x, w in zip(("out", "dq", "dk", "dv"), want):
            _close(got[f"{name}_{x}"], w)
        # The port's single-process flash_attention through its Function.
        tq, tk, tv = _t(q, k, v, grad=True)
        single = tfa.flash_attention(tq, tk, tv, **kw)
        single.backward(torch.tensor(do))
        for x, t in zip(("out", "dq", "dk", "dv"),
                        (single, tq.grad, tk.grad, tv.grad)):
            _close(got[f"{name}_{x}"], t.detach())

    def test_unknown_impl_raises(self):
        q, k, v, _ = _qkv(8, 1, 4, 4, 2, 1, 32)
        with pytest.raises(ValueError, match="impl"):
            tring.ring_attention(*_t(q, k, v), group=None, impl="flash")


ULYSSES_CASES = [
    ("gqa_expand", 4, 2, dict()),
    ("window_softcap", 4, 1, dict(window=5, attn_softcap=4.0)),
    ("mha_scale_ref", 4, 4, dict(impl="reference", scale=0.2)),
]


@pytest.fixture(scope="module")
def ulysses_runs(tmp_path_factory):
    """One spawned gloo group per world size (2, 4), each running every
    Ulysses case."""
    tmp = tmp_path_factory.mktemp("ulysses")
    inputs, out = {}, {}
    for name, H, Hkv, _ in ULYSSES_CASES:
        for x, a in zip(("q", "k", "v", "do"),
                        _qkv(9, 2, 16, 16, H, Hkv, 32)):
            inputs[f"{name}_{x}"] = a
    cases = [(name, kw) for name, _, _, kw in ULYSSES_CASES]
    for world in (2, 4):
        out[world] = torch_spawn.run_ranks(torch_spawn.ulysses_worker, world,
                                           tmp, inputs, cases)
    return inputs, out


class TestUlysses:
    @pytest.mark.parametrize("world", [2, 4])
    @pytest.mark.parametrize("name", [c[0] for c in ULYSSES_CASES])
    def test_matches_jax_ulysses_and_single_process(self, ulysses_runs,
                                                    world, name):
        inputs, runs = ulysses_runs
        got = runs[world]
        kw = dict(next(c[3] for c in ULYSSES_CASES if c[0] == name))
        kw.pop("impl", None)
        q, k, v, do = (inputs[f"{name}_{x}"] for x in ("q", "k", "v", "do"))
        mesh = jax_make_mesh({"sp": world}, devices=jax.devices()[:world])

        @jax.jit
        def fwd_bwd(a, b, c, d):
            out, vjp = jax.vjp(lambda a, b, c: jax_ulysses_sharded(
                a, b, c, mesh=mesh, impl="reference", **kw), a, b, c)
            return (out,) + tuple(vjp(d))
        want = fwd_bwd(q, k, v, jnp.asarray(do))
        for x, w in zip(("out", "dq", "dk", "dv"), want):
            _close(got[f"{name}_{x}"], w)
        tq, tk, tv = _t(q, k, v, grad=True)
        single = tfa.flash_attention(tq, tk, tv, **kw)
        single.backward(torch.tensor(do))
        for x, t in zip(("out", "dq", "dk", "dv"),
                        (single, tq.grad, tk.grad, tv.grad)):
            _close(got[f"{name}_{x}"], t.detach())

    def test_group_of_one_and_refusals(self, tmp_path):
        """A group of one (a one-rank gloo group in this process) does no
        collective: the output is the single-process attention's, bit
        for bit; a head count the group does not divide and an unknown
        impl raise."""
        import torch.distributed as dist
        tul = importlib.import_module("tpushare_torch.parallel.ulysses")
        q, k, v, _ = _qkv(10, 1, 6, 6, 2, 1, 32)
        dist.init_process_group(
            "gloo", store=dist.FileStore(str(tmp_path / "store"), 1),
            rank=0, world_size=1)
        try:
            group = dist.new_group([0])
            got = tul.ulysses_attention(*_t(q, k, v), group=group)
            assert torch.equal(got, tfa.flash_attention(*_t(q, k, v)))
            with pytest.raises(ValueError, match="impl"):
                tul.ulysses_attention(*_t(q, k, v), group=group,
                                      impl="flash")
        finally:
            dist.destroy_process_group()


A2A_MESHES = {"dp2_sp2": {"dp": 2, "sp": 2}, "dp1_sp4": {"sp": 4}}
A2A_LR = 0.05


@pytest.fixture(scope="module")
def a2a_train_runs(tmp_path_factory):
    """The dense LM (GQA 4/2 heads, a window of 6 across shards of 4 and
    8 positions, a softcap) trained 2 SGD steps and 2 AdamW steps (from
    a non-zero state) with sp_impl="a2a" on each mesh: one gloo group
    of 4 each."""
    from tpushare.models import transformer as jt
    from tpushare_torch.models import bridge
    tmp = tmp_path_factory.mktemp("a2a_train")
    jcfg = jt.tiny(remat=True, sliding_window=6, attn_softcap=20.0)
    jp = jt.init_params(jax.random.PRNGKey(3), jcfg)
    tok = np.random.default_rng(41).integers(0, jcfg.vocab_size, (2, 17))
    # A non-zero AdamW state whose moments dominate the next gradients
    # (tests/test_torch_train.py's reason: a first step from zeros is
    # near sign(g), which turns summation-order noise into lr-sized
    # differences).
    rng = np.random.default_rng(5)
    state = {"mu": jax.tree.map(lambda a: (rng.normal(size=a.shape) * 1e-2
                                           ).astype(np.float32), jp),
             "nu": jax.tree.map(lambda a: rng.uniform(
                 1e-4, 4e-4, size=a.shape).astype(np.float32), jp),
             "count": np.int32(4)}
    inputs = {"tokens": tok, "count": np.asarray(state["count"]),
              **torch_spawn.flatten(jax.tree.map(np.asarray, jp), "p/"),
              **torch_spawn.flatten(state["mu"], "mu/"),
              **torch_spawn.flatten(state["nu"], "nu/")}
    tcfg = bridge.config_from_jax(jcfg)
    runs = {name: torch_spawn.run_ranks(torch_spawn.a2a_train_worker, 4, tmp,
                                        inputs, tcfg, sizes, A2A_LR, 2)
            for name, sizes in A2A_MESHES.items()}
    return jcfg, jp, tcfg, tok, state, runs


class TestUlyssesTraining:
    @pytest.mark.parametrize("mesh_name", list(A2A_MESHES))
    def test_sgd_and_adamw_steps(self, a2a_train_runs, mesh_name):
        """Losses within 1e-5 relative and parameters within 2e-6 abs of
        the JAX a2a SGD step and of the port's single-process steps
        (the same tolerances as tests/test_torch_train.py)."""
        from tpushare.models import training as jtr
        from tpushare_torch.models import bridge
        from tpushare_torch.models import training as ttr
        jcfg, jp0, tcfg, tok, state, runs = a2a_train_runs
        got = runs[mesh_name]
        mesh = jax_make_mesh(A2A_MESHES[mesh_name], devices=jax.devices()[:4])
        step = jtr.make_spmd_train_step(jcfg, mesh, lr=A2A_LR, sp_impl="a2a")
        jp = jp0
        tp = bridge.params_from_jax(jp0, device="cpu")
        ta = bridge.params_from_jax(jp0, device="cpu")
        tstate = bridge.opt_state_from_jax(state, device="cpu")
        for s in range(2):
            jp, jloss = step(jp, jnp.asarray(tok))
            tp, tloss = ttr.sgd_train_step(tp, torch.tensor(tok), tcfg,
                                           lr=A2A_LR)
            ta, tstate, aloss = ttr.adamw_train_step(
                ta, tstate, torch.tensor(tok), tcfg, lr=A2A_LR)
            for want in (jloss, tloss):
                np.testing.assert_allclose(float(got[f"sgd_loss{s}"]),
                                           float(want), rtol=1e-5)
            np.testing.assert_allclose(float(got[f"adamw_loss{s}"]),
                                       float(aloss), rtol=1e-5)
        flat = torch_spawn.flatten(jax.tree.map(np.asarray, jp))
        for key, want in flat.items():
            _close(got["sgd/" + key], want, atol=2e-6)
        for prefix, tree in (("sgd/", tp), ("adamw/", ta)):
            for key, want in torch_spawn.flatten(tree).items():
                _close(got[prefix + key], want, atol=2e-6)
