"""Parity of the PyTorch port's ops (tpushare_torch.ops) with the JAX
package's, on the CPU in f32: the same numpy inputs, made from a seed,
go through the JAX function and its counterpart in the port.

The kernel wrappers run their plain PyTorch versions here (CPU
tensors); the JAX Pallas kernels run in interpret mode, as the JAX
package's own tests run them. Tolerances: 1e-5 abs for elementwise ops
and the reference einsum (f32, summation order only); 2e-5 for the
flash/paged paths, whose online softmax sums in tiles on the JAX side
and in one pass on the port's.
"""

import ast
import importlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.router.chainkeys import chain_keys as jax_chain_keys

import tpushare_torch
from tpushare_torch.router.chainkeys import chain_keys

# Module objects (the packages re-export functions of the same names).
jattn = importlib.import_module("tpushare.ops.attention")
jfa = importlib.import_module("tpushare.ops.flash_attention")
jnorms = importlib.import_module("tpushare.ops.norms")
jrot = importlib.import_module("tpushare.ops.rotary")
tattn = importlib.import_module("tpushare_torch.ops.attention")
tfa = importlib.import_module("tpushare_torch.ops.flash_attention")
tnorms = importlib.import_module("tpushare_torch.ops.norms")
trot = importlib.import_module("tpushare_torch.ops.rotary")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
FLASH_ATOL = 2e-5


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale
            ).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=0, atol=atol)


class TestNorms:
    @pytest.mark.parametrize("offset", [0.0, 1.0])
    def test_rms_norm(self, offset):
        x, w = _np(0, 3, 5, 64, scale=3.0), _np(1, 64)
        _close(tnorms.rms_norm(_t(x), _t(w), offset=offset),
               jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w),
                               offset=offset))

    def test_layer_norm(self):
        x, w, b = _np(2, 4, 32), _np(3, 32), _np(4, 32)
        _close(tnorms.layer_norm(_t(x), _t(w), _t(b)),
               jnorms.layer_norm(*map(jnp.asarray, (x, w, b))))


class TestRotary:
    @pytest.mark.parametrize("scaling", [None, (8.0, 1.0, 4.0, 64)])
    def test_rotary(self, scaling):
        pos = np.random.default_rng(5).integers(0, 4000, (2, 7))
        x = _np(6, 2, 7, 3, 64)
        jc, js = jrot.rotary_embedding(jnp.asarray(pos), 64, base=5e5,
                                       scaling=scaling)
        tc, ts = trot.rotary_embedding(_t(pos), 64, base=5e5,
                                       scaling=scaling)
        # Angles reach ~4000 rad: cos/sin of an f32 angle agree to
        # ~1e-4 between the two libraries' range reductions.
        _close(tc, jc, atol=2e-4)
        _close(ts, js, atol=2e-4)
        _close(trot.apply_rotary(_t(x), _t(np.asarray(jc)),
                                 _t(np.asarray(js))),
               jrot.apply_rotary(jnp.asarray(x), jc, js))


class TestMhaReference:
    @pytest.mark.parametrize("kw", [
        {}, {"q_offset": 9}, {"window": 6}, {"attn_softcap": 5.0},
        {"causal": False}, {"scale": 0.3, "window": 0}])
    def test_matches_jax(self, kw):
        q, k, v = _np(7, 2, 5, 4, 32), _np(8, 2, 14, 2, 32), _np(9, 2, 14, 2, 32)
        _close(tattn.mha_reference(_t(q), _t(k), _t(v), **kw),
               jattn.mha_reference(*map(jnp.asarray, (q, k, v)), **kw))

    @pytest.mark.parametrize("ndim", [2, 3])
    def test_kv_mask(self, ndim):
        q, k, v = _np(10, 2, 3, 4, 16), _np(11, 2, 9, 1, 16), _np(12, 2, 9, 1, 16)
        shape = (2, 9) if ndim == 2 else (2, 3, 9)
        mask = np.random.default_rng(13).random(shape) < 0.7
        mask[..., 0] = True
        _close(tattn.mha_reference(_t(q), _t(k), _t(v), causal=False,
                                   kv_mask=_t(mask)),
               jattn.mha_reference(*map(jnp.asarray, (q, k, v)),
                                   causal=False, kv_mask=jnp.asarray(mask)))


class TestFlashAttentionPlain:
    """The plain version the wrapper runs on CPU against the JAX Pallas
    kernel in interpret mode (tileable shapes) and against the JAX
    reference (shapes the Pallas kernel cannot tile)."""

    @pytest.mark.parametrize("Sk,q_offset,window,softcap", [
        (128, 0, None, None),
        (256, 128, None, None),
        (256, 100, 48, None),
        (128, 0, None, 30.0),
        (256, 128, 64, 20.0),
    ])
    def test_vs_pallas_interpret(self, Sk, q_offset, window, softcap):
        q = _np(20, 1, 128, 4, 128)
        k, v = _np(21, 1, Sk, 2, 128), _np(22, 1, Sk, 2, 128)
        want = jfa.flash_attention(
            *map(jnp.asarray, (q, k, v)), q_offset=q_offset, window=window,
            attn_softcap=softcap, block_q=128, block_k=128, interpret=True)
        got = tfa.flash_attention(_t(q), _t(k), _t(v), q_offset=q_offset,
                                  window=window, attn_softcap=softcap)
        _close(got, want, atol=FLASH_ATOL)

    @pytest.mark.parametrize("Sq,Sk,q_offset", [(5, 37, 30), (1, 20, 19),
                                                (17, 17, 0)])
    def test_untileable_vs_reference(self, Sq, Sk, q_offset):
        q, k, v = _np(23, 2, Sq, 6, 32), _np(24, 2, Sk, 3, 32), _np(25, 2, Sk, 3, 32)
        want = jattn.mha_reference(*map(jnp.asarray, (q, k, v)),
                                   q_offset=q_offset, window=8)
        got = tfa.flash_attention(_t(q), _t(k), _t(v), q_offset=q_offset,
                                  window=8)
        _close(got, want)

    def test_attention_dispatch(self):
        q, k, v = _np(26, 1, 4, 2, 16), _np(27, 1, 4, 2, 16), _np(28, 1, 4, 2, 16)
        before = tfa.flash_attention.launches
        for impl in ("auto", "reference"):
            _close(tattn.attention(_t(q), _t(k), _t(v), impl=impl),
                   jattn.mha_reference(*map(jnp.asarray, (q, k, v))))
        assert tfa.flash_attention.launches == before   # CPU: no kernel
        for impl in ("pallas", "flash"):
            with pytest.raises(ValueError):
                tattn.attention(_t(q), _t(k), _t(v), impl=impl)


def _paged_case(seed=30, B=4, H=8, Hkv=2, D=128, nb=12, bs=16, mb=5):
    rng = np.random.default_rng(seed)
    pool_k = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    # Ragged rows; -1 past each slot's live pages; block 2 shared by
    # slots 0 and 3 (a prefix hit).
    table = np.array([[2, 7, 1, -1, -1], [0, -1, -1, -1, -1],
                      [5, 8, 6, 4, 9], [2, 10, -1, -1, -1]], np.int32)
    pos = np.array([40, 3, 77, 17], np.int32)
    q = rng.normal(size=(B, 1, H, D)).astype(np.float32)
    return q, pool_k, pool_v, table[:, :mb], pos


class TestPagedDecodePlain:
    @pytest.mark.parametrize("window,softcap", [(None, None), (24, None),
                                                (None, 25.0), (20, 30.0)])
    def test_vs_pallas_interpret(self, window, softcap):
        q, pk, pv, table, pos = _paged_case()
        want = jfa.paged_flash_decode(
            *map(jnp.asarray, (q, pk, pv, table, pos)), window=window,
            attn_softcap=softcap, interpret=True)
        got = tfa.paged_flash_decode(*map(_t, (q, pk, pv, table, pos)),
                                     window=window, attn_softcap=softcap)
        _close(got, want, atol=FLASH_ATOL)

    def test_mha_no_group_and_scale(self):
        q, pk, pv, table, pos = _paged_case(seed=31, H=2, Hkv=2)
        want = jfa.paged_flash_decode(
            *map(jnp.asarray, (q, pk, pv, table, pos)), scale=0.05,
            interpret=True)
        got = tfa.paged_flash_decode(*map(_t, (q, pk, pv, table, pos)),
                                     scale=0.05)
        _close(got, want, atol=FLASH_ATOL)

    def test_slot_with_no_live_row_is_zero(self):
        """An all -1 row (an inactive slot) is masked entirely: the
        kernel contract gives 0, never an average of junk pages."""
        q, pk, pv, table, pos = _paged_case()
        table[1] = -1
        got = tfa.paged_flash_decode(*map(_t, (q, pk, pv, table, pos)))
        assert torch.all(got[1] == 0)
        assert torch.isfinite(got).all()


class TestPortBoundary:
    def test_chain_keys_byte_identical(self):
        prompt = np.random.default_rng(40).integers(0, 50_000, 70)
        for salt in (b"", b"adapter:3"):
            assert chain_keys(prompt, 16, 4, salt=salt) == \
                jax_chain_keys(prompt, 16, 4, salt=salt)

    def test_no_jax_or_tpushare_imports(self):
        """Nothing under tpushare_torch/ or in chip_smoke.py imports
        jax or the JAX package."""
        files = [os.path.join(ROOT, "chip_smoke.py")]
        for dirpath, _, names in os.walk(os.path.join(ROOT,
                                                      "tpushare_torch")):
            files += [os.path.join(dirpath, n) for n in names
                      if n.endswith(".py")]
        bad = []
        for path in files:
            tree = ast.parse(open(path).read(), path)
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom):
                    mods = [node.module or ""]
                else:
                    continue
                for m in mods:
                    if m.split(".")[0] in ("jax", "jaxlib", "tpushare"):
                        bad.append(f"{os.path.relpath(path, ROOT)}: {m}")
        assert len(files) > 10
        assert bad == []

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpushare_torch.resolve_device()
        from tpushare_torch.models import transformer as tt
        with pytest.raises(RuntimeError):
            tt.init_params(0, tt.tiny())
        assert tpushare_torch.resolve_device("cpu").type == "cpu"

    def test_kernel_wrappers_refuse_what_the_kernel_cannot_take(self):
        """On a CUDA tensor a wrapper launches or raises; the shape
        and type checks run before any build."""
        meta = torch.empty((1, 4, 2, 32), device="meta")
        with pytest.raises(ValueError, match="head_dim"):
            tfa.flash_attention(meta, meta, meta)
        q = torch.empty((2, 1, 4, 128), device="meta")
        pool = torch.empty((6, 16, 2, 128), device="meta")
        table = torch.empty((2, 3), dtype=torch.int64, device="meta")
        pos = torch.empty((2,), dtype=torch.int32, device="meta")
        with pytest.raises(ValueError, match="int32"):
            tfa.paged_flash_decode(q, pool, pool, table, pos)
