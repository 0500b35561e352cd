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
jq8 = importlib.import_module("tpushare.ops.q8_expert")
tattn = importlib.import_module("tpushare_torch.ops.attention")
tq8 = importlib.import_module("tpushare_torch.ops.q8_expert")
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


def _jax_scales(s):
    """Port scale pages [nb, Hkv, bs] -> JAX's padded [nb, Hkv_pad, bs]."""
    from tpushare.models.quant import kv_scale_pad
    nb, hkv, bs = s.shape
    out = np.zeros((nb, kv_scale_pad(hkv), bs), np.float32)
    out[:, :hkv] = s
    return out


def _int8_pages(pk, pv):
    """Quantize f32 pages as the kv_quant pools hold them: int8 pages
    and f32 scale pages in the port's [nb, Hkv, bs] layout."""
    from tpushare_torch.models.quant import (kv_quantize,
                                             scales_to_pool_layout)
    qk, sk = kv_quantize(_t(pk))
    qv, sv = kv_quantize(_t(pv))
    return (qk.numpy(), qv.numpy(), scales_to_pool_layout(sk).numpy(),
            scales_to_pool_layout(sv).numpy())


def _verify_case(Sq, seed=50, B=3, H=4, Hkv=2, D=128, nb=24, bs=8, mb=8):
    """Slots whose pages cover positions through pos[b] + Sq - 1 (the
    JAX kernel clamps -1 entries to page 0 instead of masking them, so
    no compared row may reach one), a prefix page shared by slots 0
    and 2, -1 past each slot's pages."""
    rng = np.random.default_rng(seed)
    pool_k = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    pool_v = rng.normal(size=(nb, bs, Hkv, D)).astype(np.float32)
    pos = np.array([9, 0, 21], np.int32)[:B]
    table = np.full((B, mb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B):
        n = (int(pos[b]) + Sq - 1) // bs + 1
        assert n <= mb
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[2, 0] = table[0, 0]
    q = rng.normal(size=(B, Sq, H, D)).astype(np.float32)
    return q, pool_k, pool_v, table, pos


class TestPagedVerifyPlain:
    """``paged_flash_verify_plain`` (what the wrapper runs on CPU)
    against the JAX ``_paged_verify_kernel`` in interpret mode."""

    @pytest.mark.parametrize("int8", [False, True])
    @pytest.mark.parametrize("Sq,window,softcap", [
        (2, None, None), (5, None, None), (16, 12, None), (40, 20, 30.0)])
    def test_vs_pallas_interpret(self, Sq, window, softcap, int8):
        q, pk, pv, table, pos = _verify_case(Sq)
        kw, tkw = {}, {}
        if int8:
            pk, pv, sk, sv = _int8_pages(pk, pv)
            kw = {"k_scale": jnp.asarray(_jax_scales(sk)),
                  "v_scale": jnp.asarray(_jax_scales(sv))}
            tkw = {"k_scale": _t(sk), "v_scale": _t(sv)}
        want = jfa.paged_flash_verify(
            *map(jnp.asarray, (q, pk, pv, table, pos)), window=window,
            attn_softcap=softcap, interpret=True, **kw)
        got = tfa.paged_flash_verify(*map(_t, (q, pk, pv, table, pos)),
                                     window=window, attn_softcap=softcap,
                                     **tkw)
        assert got.shape == q.shape
        _close(got, want, atol=FLASH_ATOL)

    def test_row_s_attends_through_pos_plus_s(self):
        """Sq = 1 of the verify plain version is the decode plain
        version; each later row sees one more position."""
        q, pk, pv, table, pos = _verify_case(4, seed=51)
        got = tfa.paged_flash_verify_plain(*map(_t, (q, pk, pv, table,
                                                     pos)))
        for s in range(4):
            one = tfa.paged_flash_decode_plain(
                _t(q[:, s:s + 1]), _t(pk), _t(pv), _t(table), _t(pos + s))
            _close(got[:, s:s + 1], one, atol=1e-6)


class TestPagedDecodeInt8Plain:
    @pytest.mark.parametrize("window,softcap", [(None, None), (20, 30.0)])
    def test_vs_pallas_interpret(self, window, softcap):
        q, pk, pv, table, pos = _paged_case(seed=32)
        qk, qv, sk, sv = _int8_pages(pk, pv)
        want = jfa.paged_flash_decode(
            *map(jnp.asarray, (q, qk, qv, table, pos)), window=window,
            attn_softcap=softcap, k_scale=jnp.asarray(_jax_scales(sk)),
            v_scale=jnp.asarray(_jax_scales(sv)), interpret=True)
        got = tfa.paged_flash_decode(*map(_t, (q, qk, qv, table, pos)),
                                     window=window, attn_softcap=softcap,
                                     k_scale=_t(sk), v_scale=_t(sv))
        _close(got, want, atol=FLASH_ATOL)

    def test_dequantizes_in_f32_like_the_kernel(self):
        """Int8 pages times their scales in f32 give exactly the f32
        pages' answer: the dequantization is the only difference."""
        q, pk, pv, table, pos = _paged_case(seed=33)
        qk, qv, sk, sv = _int8_pages(pk, pv)
        got = tfa.paged_flash_decode_plain(*map(_t, (q, qk, qv, table, pos)),
                                           k_scale=_t(sk), v_scale=_t(sv))
        deq_k = qk.astype(np.float32) * sk.transpose(0, 2, 1)[..., None]
        deq_v = qv.astype(np.float32) * sv.transpose(0, 2, 1)[..., None]
        want = tfa.paged_flash_decode_plain(*map(_t, (q, deq_k, deq_v,
                                                      table, pos)))
        _close(got, want, atol=1e-6)


def _q8_operands(seed, E, C, Dm, Fd, shared, dtype):
    """x and one layer's int8 expert leaves (quantize_weight of random
    f32 weights), as numpy arrays."""
    from tpushare_torch.models.quant import quantize_weight
    rng = np.random.default_rng(seed)
    ws = []
    for shape, fan in (((E, Dm, Fd), Dm), ((E, Dm, Fd), Dm),
                       ((E, Fd, Dm), Fd)):
        q, sc = quantize_weight(torch.from_numpy(
            rng.normal(size=shape).astype(np.float32) / fan ** 0.5))
        ws += [q.numpy(), sc.numpy()]
    x = rng.normal(size=(C, Dm) if shared else (E, C, Dm)).astype(np.float32)
    if dtype == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    return x, ws


class TestQ8ExpertPlain:
    """The port's plain q8 expert FFN against JAX q8_expert_ffn_reference
    (its parity truth). The JAX reference, not its interpret-mode kernel:
    the interpreter-parity tests of tests/test_q8_expert.py fail on the
    CPU, so that path is no oracle. bf16 x: the same bf16
    values in both, outputs compared in f32 after each side's bf16
    rounding (one bf16 step apart at most)."""

    @pytest.mark.parametrize("C", [1, 8, 37])
    @pytest.mark.parametrize("shared", [True, False])
    @pytest.mark.parametrize("act", ["silu", "gelu"])
    @pytest.mark.parametrize("dtype", ["f32", "bf16"])
    def test_matches_jax_reference(self, C, shared, act, dtype):
        x, ws = _q8_operands(60 + C, 3, C, 32, 48, shared, dtype)
        jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
        tdt = torch.float32 if dtype == "f32" else torch.bfloat16
        want = jq8.q8_expert_ffn_reference(
            jnp.asarray(x, jdt), *map(jnp.asarray, ws), act=act)
        got = tq8.q8_expert_ffn(_t(x).to(tdt), *map(_t, ws), act=act)
        assert got.dtype == tdt and tuple(got.shape) == (3, C, 32)
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "f32":
            _close(got, want, atol=2e-5)
        else:
            d = np.abs(got.float().numpy() - want)
            assert (d <= 2.0 ** -7 * np.abs(want) + 1e-5).all()

    def test_dispatch_runs_the_plain_version_on_cpu(self):
        x, ws = _q8_operands(70, 2, 5, 32, 48, True, "f32")
        before = tq8.q8_expert_ffn.launches
        got = tq8.q8_expert_dispatch(_t(x), *map(_t, ws))
        want = tq8.q8_expert_ffn_reference(_t(x), *map(_t, ws))
        assert torch.equal(got, want)
        assert tq8.q8_expert_ffn.launches == before


class TestFlashDecodePlain:
    """flash_decode's plain version against the oracle the reference
    model's dense ragged S = 1 branch builds (transformer.py:599-607):
    JAX mha_reference with kv_mask = arange(M) <= pos, windowed."""

    @pytest.mark.parametrize("H,Hkv", [(4, 4), (4, 2), (8, 2)])
    @pytest.mark.parametrize("window", [None, 5, 64])
    @pytest.mark.parametrize("softcap", [None, 20.0])
    def test_matches_jax_masked_reference(self, H, Hkv, window, softcap):
        B, M, D = 4, 24, 32
        q, k, v = _np(80, B, 1, H, D), _np(81, B, M, Hkv, D), \
            _np(82, B, M, Hkv, D)
        pos = np.array([0, 23, 11, 6], np.int32)
        mask = np.arange(M)[None, :] <= pos[:, None]
        if window is not None:
            mask &= np.asarray(jattn.window_keep(
                jnp.asarray(pos[:, None]), jnp.arange(M)[None, :], window))
        want = jattn.mha_reference(*map(jnp.asarray, (q, k, v)),
                                   causal=False, kv_mask=jnp.asarray(mask),
                                   attn_softcap=softcap)
        got = tfa.flash_decode(_t(q), _t(k), _t(v), _t(pos), window=window,
                               attn_softcap=softcap)
        _close(got, want)


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
        names = {os.path.relpath(f, ROOT) for f in files}
        for mod in ("ops/q8_expert.py", "models/moe.py", "models/convert.py",
                    "models/serving.py", "ops/flash_attention.py",
                    "models/kvtier.py", "router/core.py",
                    "router/daemon.py", "router/smoke.py",
                    "router/offload_smoke.py", "utils/profiling.py",
                    "plugin/allocate.py", "plugin/nvmldisc.py",
                    "deviceplugin/rpc.py", "k8s/client.py",
                    "models/bert.py", "tools/colocate.py",
                    "models/lora.py", "utils/data.py",
                    "utils/checkpoint.py", "models/speculative.py",
                    "parallel/ulysses.py", "tools/finetune_serve.py",
                    "parallel/mesh.py", "models/training.py",
                    "models/pipeline.py", "models/moe_pipeline.py",
                    "models/resnet.py", "tools/saturation.py",
                    "parallel/sharding.py", "parallel/control.py",
                    "tools/multichip.py", "tools/tp_drift.py"):
            assert os.path.join("tpushare_torch", mod) in names
        assert bad == []

    def test_default_device_raises_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpushare_torch.resolve_device()
        from tpushare_torch.models import resnet
        from tpushare_torch.models import transformer as tt
        with pytest.raises(RuntimeError):
            tt.init_params(0, tt.tiny())
        with pytest.raises(RuntimeError):
            resnet.init_params(0, resnet.tiny())
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
        table = torch.empty((2, 3), dtype=torch.int32, device="meta")
        q5 = torch.empty((2, 5, 4, 128), device="meta")
        with pytest.raises(ValueError, match="Sq must be >= 2"):
            tfa.paged_flash_verify(q, pool, pool, table, pos)
        pool8 = torch.empty((6, 16, 2, 128), dtype=torch.int8, device="meta")
        with pytest.raises(ValueError, match="both k_scale and v_scale"):
            tfa.paged_flash_verify(q5, pool8, pool8, table, pos,
                                   k_scale=pool)
        scale = torch.empty((6, 16, 2), device="meta")      # rows, not pages
        with pytest.raises(ValueError, match="scale pages"):
            tfa.paged_flash_verify(q5, pool8, pool8, table, pos,
                                   k_scale=scale, v_scale=scale)
        rows = torch.empty((2, 40, 2, 128), device="meta")
        with pytest.raises(ValueError, match="int32"):
            tfa.flash_decode(q, rows, rows, pos.long())
        with pytest.raises(ValueError, match="Sq must be 1"):
            tfa.flash_decode(q5, rows, rows, pos)
        w8 = torch.empty((2, 256, 384), dtype=torch.int8, device="meta")
        wd8 = torch.empty((2, 384, 256), dtype=torch.int8, device="meta")
        sg = torch.empty((2, 1, 384), device="meta")
        sd = torch.empty((2, 1, 256), device="meta")
        x = torch.empty((4, 256), dtype=torch.float16, device="meta")
        with pytest.raises(ValueError, match="f32 or bf16"):
            tq8.q8_expert_ffn(x, w8, sg, w8, sg, wd8, sd)
        with pytest.raises(ValueError, match="x must be"):
            tq8.q8_expert_ffn(x[:, :8].float(), w8, sg, w8, sg, wd8, sd)
