"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Marked ``cuda``: here, without a card, every test skips with its
reason. This file imports no JAX (the machine with the card has none),
so it runs there without the repo's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tolerances: f32 inputs 2e-5 abs (the kernel sums in another order).
bf16 inputs, per element: |got - want| <= 2^-7 |want| + 1e-5. Both
sides compute in f32 and round the output to bf16, so an element may
differ by the one bf16 step its rounding flipped, which is at most
2^-7 of its magnitude; the check stays relative, so it keeps its power
on long rows whose outputs are small (the floor covers elements near
0). The same rule as chip_smoke.py's.
"""

import importlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

fa = importlib.import_module("tpushare_torch.ops.flash_attention")
attn_mod = importlib.import_module("tpushare_torch.ops.attention")
q8 = importlib.import_module("tpushare_torch.ops.q8_expert")

pytestmark = pytest.mark.cuda

F32_TOL = 2e-5


def _assert_close(got, want, dtype):
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        assert d.max().item() <= F32_TOL, d.max().item()
    else:
        lim = 2.0 ** -7 * want.float().abs() + 1e-5
        assert bool((d <= lim).all()), (d / lim).max().item()


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(gen, *shape, dtype, dev):
    return torch.randn(*shape, generator=gen, device=dev).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,q_offset,window,softcap", [
    (1, 128, 128, 8, 1, 256, 0, None, None),
    (2, 17, 200, 4, 2, 128, 150, None, None),
    (1, 1, 77, 8, 8, 128, 76, None, None),
    (1, 130, 300, 32, 8, 128, 170, 50, 30.0),
    (1, 64, 64, 8, 4, 256, 0, 16, 50.0),
])
def test_flash_prefill_vs_plain(dev, dtype, B, Sq, Sk, H, Hkv, D, q_offset,
                                window, softcap):
    g = torch.Generator(device=dev).manual_seed(0)
    q = _rand(g, B, Sq, H, D, dtype=dtype, dev=dev)
    k = _rand(g, B, Sk, Hkv, D, dtype=dtype, dev=dev)
    v = _rand(g, B, Sk, Hkv, D, dtype=dtype, dev=dev)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, q_offset=q_offset, window=window,
                             attn_softcap=softcap)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = attn_mod.mha_reference(q, k, v, q_offset=q_offset, window=window,
                                  attn_softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,bs,window,softcap", [
    (8, 1, 256, 16, None, None),
    (32, 8, 128, 16, None, None),
    (4, 2, 128, 8, 20, 30.0),
    (8, 4, 128, 24, None, 50.0),
    # GQA groups off the main paths (S > 1 at these shapes): g 3 pads to
    # 4 heads, g 24 takes three blocks of 8 per kv head, g 12 one of 8
    # and one of 4.
    (12, 4, 128, 16, 40, 50.0),
    (24, 1, 256, 16, None, None),
    (12, 1, 128, 24, None, None),
])
def test_paged_decode_vs_plain(dev, dtype, H, Hkv, D, bs, window, softcap):
    g = torch.Generator(device=dev).manual_seed(1)
    B, nb, mb = 5, 40, 9
    pool_k = _rand(g, nb, bs, Hkv, D, dtype=dtype, dev=dev)
    pool_v = _rand(g, nb, bs, Hkv, D, dtype=dtype, dev=dev)
    rng = np.random.default_rng(2)
    table = np.full((B, mb), -1, np.int32)
    pos = np.array([0, bs * 3 + 2, bs * mb - 1, 5, 0], np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B - 1):
        n = int(pos[b]) // bs + 1
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[3, 0] = table[1, 0]                      # a shared page
    table[4] = -1                                  # an inactive slot
    table_t = torch.as_tensor(table, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    q = _rand(g, B, 1, H, D, dtype=dtype, dev=dev)
    before = fa.paged_flash_decode.launches
    got = fa.paged_flash_decode(q, pool_k, pool_v, table_t, pos_t,
                                window=window, attn_softcap=softcap)
    torch.cuda.synchronize()
    assert fa.paged_flash_decode.launches == before + 1
    want = fa.paged_flash_decode_plain(q, pool_k, pool_v, table_t, pos_t,
                                       window=window, attn_softcap=softcap)
    _assert_close(got, want, dtype)
    assert torch.all(got[4] == 0)


def _paged_inputs(g, dev, dtype, B, Sq, H, Hkv, D, bs, nb, mb, pos, int8):
    """A pool laid out as the server lays it out: slot b owns the pages
    through position pos[b] + Sq - 1 (drawn from a shuffled free list),
    -1 past them, slots 0 and 3 share their first page; the last slot
    is inactive (all -1). int8 pools come from kv_quantize of random
    rows, with scales in the port's [nb, Hkv, bs] page layout."""
    from tpushare_torch.models import quant
    rows_k = _rand(g, nb, bs, Hkv, D, dtype=torch.float32, dev=dev)
    rows_v = _rand(g, nb, bs, Hkv, D, dtype=torch.float32, dev=dev)
    if int8:
        pool_k, sk = quant.kv_quantize(rows_k)
        pool_v, sv = quant.kv_quantize(rows_v)
        scales = {"k_scale": quant.scales_to_pool_layout(sk),
                  "v_scale": quant.scales_to_pool_layout(sv)}
    else:
        pool_k, pool_v, scales = rows_k.to(dtype), rows_v.to(dtype), {}
    rng = np.random.default_rng(2)
    table = np.full((B, mb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B - 1):
        n = min(mb, (int(pos[b]) + Sq - 1) // bs + 1)
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[3, 0] = table[0, 0]                      # a shared page
    q = _rand(g, B, Sq, H, D, dtype=dtype, dev=dev)
    return (q, pool_k, pool_v, torch.as_tensor(table, device=dev),
            torch.as_tensor(np.asarray(pos, np.int32), device=dev), scales)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,Hkv,D,bs,window,softcap", [
    (8, 1, 256, 16, None, None),
    (32, 8, 128, 16, None, None),
    (4, 2, 128, 8, 20, 30.0),
])
def test_paged_decode_int8_vs_plain(dev, dtype, H, Hkv, D, bs, window,
                                    softcap):
    g = torch.Generator(device=dev).manual_seed(3)
    pos = [bs * 3 + 2, 0, bs * 9 - 1, 5, 0]
    q, pk, pv, table, pos_t, sc = _paged_inputs(
        g, dev, dtype, 5, 1, H, Hkv, D, bs, 40, 9, pos, int8=True)
    before = fa.paged_flash_decode.launches_int8
    got = fa.paged_flash_decode(q, pk, pv, table, pos_t, window=window,
                                attn_softcap=softcap, **sc)
    torch.cuda.synchronize()
    assert fa.paged_flash_decode.launches_int8 == before + 1
    want = fa.paged_flash_decode_plain(q, pk, pv, table, pos_t,
                                       window=window, attn_softcap=softcap,
                                       **sc)
    _assert_close(got, want, dtype)
    assert torch.all(got[4] == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Sq,H,Hkv,D,bs,window,softcap", [
    (5, 32, 8, 128, 16, None, None),
    (5, 8, 1, 256, 16, None, None),
    (40, 8, 4, 256, 16, 24, 50.0),
    (130, 32, 8, 128, 16, None, None),
])
def test_paged_verify_vs_plain(dev, dtype, int8, Sq, H, Hkv, D, bs, window,
                               softcap):
    g = torch.Generator(device=dev).manual_seed(4)
    mb = 16
    pos = [bs * 3 + 2, 0, bs * mb - Sq - 3, 5, 0]
    q, pk, pv, table, pos_t, sc = _paged_inputs(
        g, dev, dtype, 5, Sq, H, Hkv, D, bs, 90, mb, pos, int8=int8)
    attr = "launches_int8" if int8 else "launches"
    before = getattr(fa.paged_flash_verify, attr)
    got = fa.paged_flash_verify(q, pk, pv, table, pos_t, window=window,
                                attn_softcap=softcap, **sc)
    torch.cuda.synchronize()
    assert getattr(fa.paged_flash_verify, attr) == before + 1
    want = fa.paged_flash_verify_plain(q, pk, pv, table, pos_t,
                                       window=window, attn_softcap=softcap,
                                       **sc)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)
    assert torch.all(got[4] == 0)


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("Sq,H,Hkv,D,bs,window,softcap", [
    (512, 32, 8, 128, 16, None, None),
    (512, 8, 4, 256, 16, 300, 50.0),
])
def test_paged_verify_tc_long_vs_plain(dev, int8, Sq, H, Hkv, D, bs, window,
                                       softcap):
    """A fused tick's width over long slots whose first pages are shared
    (a prefix hit), bf16 q: the tensor-core body's gathered walk across
    many tiles, row tiles and both page types."""
    from tpushare_torch.models import quant
    g = torch.Generator(device=dev).manual_seed(16)
    B, nb, mb, prefix = 3, 400, 128, 20
    pos = np.array([700, 1200, 0], np.int32)
    rows_k = _rand(g, nb, bs, Hkv, D, dtype=torch.float32, dev=dev)
    rows_v = _rand(g, nb, bs, Hkv, D, dtype=torch.float32, dev=dev)
    sc = {}
    if int8:
        (pk, sk), (pv, sv) = quant.kv_quantize(rows_k), quant.kv_quantize(rows_v)
        sc = {"k_scale": quant.scales_to_pool_layout(sk),
              "v_scale": quant.scales_to_pool_layout(sv)}
    else:
        pk, pv = rows_k.to(torch.bfloat16), rows_v.to(torch.bfloat16)
    ids = list(np.random.default_rng(3).permutation(nb - 1))
    table = np.full((B, mb), -1, np.int32)
    for b in range(B):
        n = (int(pos[b]) + Sq - 1) // bs + 1
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[1, :prefix] = table[0, :prefix]          # a shared prefix
    q = _rand(g, B, Sq, H, D, dtype=torch.bfloat16, dev=dev)
    args = (q, pk, pv, torch.as_tensor(table, device=dev),
            torch.as_tensor(pos, device=dev))
    kw = dict(window=window, attn_softcap=softcap, **sc)
    got = fa.paged_flash_verify(*args, **kw)
    want = fa.paged_flash_verify_plain(*args, **kw)
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("M,H,Hkv,D,window,softcap", [
    (300, 8, 4, 256, None, None),
    (300, 8, 4, 256, 100, 50.0),
    (129, 32, 8, 128, None, None),
    (77, 4, 4, 128, 30, None),
    (300, 12, 4, 128, 100, 50.0),    # g 3, 24 and 12, as in the paged test
    (300, 24, 1, 256, None, None),
    (300, 12, 1, 128, None, None),
])
def test_flash_decode_vs_plain(dev, dtype, M, H, Hkv, D, window, softcap):
    """Contiguous rows, ragged positions (0, the last row, a window that
    bites and one that does not)."""
    g = torch.Generator(device=dev).manual_seed(6)
    B = 5
    k = _rand(g, B, M, Hkv, D, dtype=dtype, dev=dev)
    v = _rand(g, B, M, Hkv, D, dtype=dtype, dev=dev)
    q = _rand(g, B, 1, H, D, dtype=dtype, dev=dev)
    pos = torch.tensor([0, M - 1, M // 2, 5, M - 7], dtype=torch.int32,
                       device=dev)
    before = fa.flash_decode.launches
    got = fa.flash_decode(q, k, v, pos, window=window, attn_softcap=softcap)
    torch.cuda.synchronize()
    assert fa.flash_decode.launches == before + 1
    want = fa.flash_decode_plain(q, k, v, pos, window=window,
                                 attn_softcap=softcap)
    assert got.dtype == dtype and got.shape == q.shape
    _assert_close(got, want, dtype)


def _splits(dev, B, H, Hkv, max_rows):
    """The split count the decode wrappers launch on this card."""
    return fa.decode_splits(B, H, Hkv, max_rows, torch.cuda.
                            get_device_properties(dev).multi_processor_count)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 4096])
def test_flash_decode_long_rows_across_splits(dev, dtype, window):
    """M 8192 with Gemma-2-2B's heads: slots whose live range ends one
    before, on and one past an edge where every split holds the same
    number of tiles, the last row, 4096 (the window's width) and 0; the
    4096 window's floor falls inside a split."""
    g = torch.Generator(device=dev).manual_seed(20)
    B, M, H, Hkv, D = 6, 8192, 8, 4, 256
    S = _splits(dev, B, H, Hkv, M)
    assert S > 1
    edge = S * fa.DECODE_TILE_ROWS * (7000 // (S * fa.DECODE_TILE_ROWS))
    pos = torch.tensor([edge - 2, edge - 1, edge, M - 1, 4096, 0],
                       dtype=torch.int32, device=dev)
    k = _rand(g, B, M, Hkv, D, dtype=dtype, dev=dev)
    v = _rand(g, B, M, Hkv, D, dtype=dtype, dev=dev)
    q = _rand(g, B, 1, H, D, dtype=dtype, dev=dev)
    got = fa.flash_decode(q, k, v, pos, window=window, attn_softcap=50.0)
    want = fa.flash_decode_plain(q, k, v, pos, window=window,
                                 attn_softcap=50.0)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_one_slot_one_kv_head_most_splits(dev, int8):
    """B 1 and Hkv 1 (Gemma-2B's geometry, one slot): the most splits
    a grid takes, over a long slot with a -1 page in its range and bs
    24 (pages and tiles out of step)."""
    g = torch.Generator(device=dev).manual_seed(21)
    bs, nb, mb = 24, 400, 300
    pos = [5000, 0, 0, 0, 0]
    q, pk, pv, table, pos_t, sc = _paged_inputs(
        g, dev, torch.bfloat16, 5, 1, 8, 1, 256, bs, nb, mb, pos, int8=int8)
    q, table, pos_t = q[:1].contiguous(), table[:1].clone(), pos_t[:1]
    table[0, 77] = -1
    assert _splits(dev, 1, 8, 1, mb * bs) >= 100
    got = fa.paged_flash_decode(q, pk, pv, table, pos_t, **sc)
    want = fa.paged_flash_decode_plain(q, pk, pv, table, pos_t, **sc)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bs,window", [(16, None), (24, 1000), (16, 333)])
def test_paged_decode_int8_across_splits(dev, dtype, bs, window):
    """Int8 pages with Llama-3-8B's heads over slots of thousands of
    positions, so each slot's walk spans several splits; windows whose
    floor falls inside a split."""
    g = torch.Generator(device=dev).manual_seed(22)
    pos = [3000, 1500, 63, 2047, 0]
    q, pk, pv, table, pos_t, sc = _paged_inputs(
        g, dev, dtype, 5, 1, 32, 8, 128, bs, 700, 200, pos, int8=True)
    assert _splits(dev, 5, 32, 8, 200 * bs) > 1
    got = fa.paged_flash_decode(q, pk, pv, table, pos_t, window=window,
                                **sc)
    want = fa.paged_flash_decode_plain(q, pk, pv, table, pos_t,
                                       window=window, **sc)
    torch.cuda.synchronize()
    _assert_close(got, want, dtype)
    assert torch.all(got[4] == 0)


@pytest.mark.parametrize("int8", [False, True])
def test_paged_decode_filled_card_takes_one_split(dev, int8):
    """B x Hkv >= the card's SMs: one split, the kernel writes the
    output itself (no merge)."""
    g = torch.Generator(device=dev).manual_seed(23)
    B, H, Hkv, D, bs = 34, 32, 8, 128, 16
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    B = max(B, -(-sms // Hkv))
    pos = [(37 * b) % 900 for b in range(B)]
    q, pk, pv, table, pos_t, sc = _paged_inputs(
        g, dev, torch.bfloat16, B, 1, H, Hkv, D, bs, 2000, 60, pos,
        int8=int8)
    assert _splits(dev, B, H, Hkv, 60 * bs) == 1
    got = fa.paged_flash_decode(q, pk, pv, table, pos_t, **sc)
    want = fa.paged_flash_decode_plain(q, pk, pv, table, pos_t, **sc)
    torch.cuda.synchronize()
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("kind", ["paged", "paged_int8", "rows"])
def test_decode_is_deterministic(dev, kind):
    """Two launches on the same inputs give equal bits: the splits are
    merged in split order."""
    g = torch.Generator(device=dev).manual_seed(24)
    if kind == "rows":
        B, M = 4, 8192
        k = _rand(g, B, M, 4, 256, dtype=torch.bfloat16, dev=dev)
        q = _rand(g, B, 1, 8, 256, dtype=torch.bfloat16, dev=dev)
        pos = torch.tensor([8191, 5000, 17, 0], dtype=torch.int32,
                           device=dev)

        def run():
            return fa.flash_decode(q, k, k * 0.5, pos, attn_softcap=50.0)
    else:
        q, pk, pv, table, pos_t, sc = _paged_inputs(
            g, dev, torch.bfloat16, 5, 1, 8, 1, 256, 16, 700, 200,
            [3000, 1500, 63, 2047, 0], int8=kind == "paged_int8")

        def run():
            return fa.paged_flash_decode(q, pk, pv, table, pos_t, **sc)
    assert torch.equal(run(), run())


def _q8_weights(g, dev, E, Dm, Fd):
    from tpushare_torch.models.quant import quantize_weight
    wg, sg = quantize_weight(torch.randn(E, Dm, Fd, generator=g, device=dev)
                             / Dm ** 0.5)
    wu, su = quantize_weight(torch.randn(E, Dm, Fd, generator=g, device=dev)
                             / Dm ** 0.5)
    wd, sd = quantize_weight(torch.randn(E, Fd, Dm, generator=g, device=dev)
                             / Fd ** 0.5)
    return wg, sg, wu, su, wd, sd


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act", ["silu", "gelu"])
@pytest.mark.parametrize("C,shared", [(1, True), (8, True), (37, True),
                                      (8, False), (37, False), (130, True),
                                      (300, True), (130, False)])
def test_q8_expert_vs_plain(dev, dtype, act, C, shared):
    g = torch.Generator(device=dev).manual_seed(7)
    E, Dm, Fd = 4, 256, 384
    w = _q8_weights(g, dev, E, Dm, Fd)
    shape = (C, Dm) if shared else (E, C, Dm)
    x = _rand(g, *shape, dtype=dtype, dev=dev)
    before = q8.q8_expert_ffn.launches
    got = q8.q8_expert_ffn(x, *w, act=act)
    torch.cuda.synchronize()
    assert q8.q8_expert_ffn.launches == before + 1
    want = q8.q8_expert_ffn_reference(x, *w, act=act)
    assert got.dtype == dtype and got.shape == (E, C, Dm)
    _assert_close(got, want, dtype)


@pytest.mark.parametrize("C,shared", [(8, True), (8, False), (64, True)])
def test_q8_expert_mixtral_width_vs_plain(dev, C, shared):
    """Mixtral-8x7B's widths (d_model 4096, d_ff 14336) on two experts:
    the bf16 body's full ring depth and both passes' long walks."""
    g = torch.Generator(device=dev).manual_seed(9)
    E, Dm, Fd = 2, 4096, 14336
    w = _q8_weights(g, dev, E, Dm, Fd)
    x = _rand(g, *((C, Dm) if shared else (E, C, Dm)), dtype=torch.bfloat16,
              dev=dev)
    got = q8.q8_expert_ffn(x, *w)
    want = q8.q8_expert_ffn_reference(x, *w)
    _assert_close(got, want, torch.bfloat16)


@pytest.mark.parametrize("C,shared", [(8, True), (300, True), (130, False)])
def test_q8_expert_is_deterministic(dev, C, shared):
    """Two passes and no float atomics: the same inputs give bit-equal
    outputs launch to launch."""
    g = torch.Generator(device=dev).manual_seed(10)
    E, Dm, Fd = 4, 256, 384
    w = _q8_weights(g, dev, E, Dm, Fd)
    x = _rand(g, *((C, Dm) if shared else (E, C, Dm)), dtype=torch.bfloat16,
              dev=dev)
    assert torch.equal(q8.q8_expert_ffn(x, *w), q8.q8_expert_ffn(x, *w))


def test_q8_and_flash_decode_wrappers_raise(dev):
    g = torch.Generator(device=dev).manual_seed(8)
    wg, sg, wu, su, wd, sd = _q8_weights(g, dev, 2, 256, 384)
    x = torch.zeros((4, 256), device=dev)
    with pytest.raises(ValueError, match="f32 or bf16"):
        q8.q8_expert_ffn(x.half(), wg, sg, wu, su, wd, sd)
    with pytest.raises(ValueError, match="int8 weights"):
        q8.q8_expert_ffn(x, wg.float(), sg, wu.float(), su, wd.float(), sd)
    with pytest.raises(ValueError, match="multiples of 128"):
        q8.q8_expert_ffn(
            x[:, :200].contiguous(), wg[:, :200].contiguous(), sg,
            wu[:, :200].contiguous(), su, wd[..., :200].contiguous(),
            sd[..., :200].contiguous())
    with pytest.raises(ValueError, match="x must be"):
        q8.q8_expert_ffn(torch.zeros((3, 4, 256), device=dev), wg, sg, wu,
                         su, wd, sd)
    q = torch.zeros((2, 1, 4, 128), device=dev)
    k = torch.zeros((2, 10, 2, 128), device=dev)
    pos = torch.zeros((2,), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        fa.flash_decode(q, k, k, pos.long())
    with pytest.raises(ValueError, match="Sq must be 1"):
        fa.flash_decode(torch.zeros((2, 2, 4, 128), device=dev), k, k, pos)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa.flash_decode(q, k.bfloat16(), k.bfloat16(), pos)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    q = torch.zeros((1, 4, 2, 32), device=dev)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q)
    h = torch.zeros((1, 4, 2, 128), device=dev, dtype=torch.float16)
    with pytest.raises(ValueError, match="f32 or bf16"):
        fa.flash_attention(h, h, h)
    q = torch.zeros((1, 8, 2, 128), device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q.transpose(1, 2), q.transpose(1, 2),
                           q.transpose(1, 2))
    q1 = torch.zeros((2, 1, 4, 128), device=dev)
    q5 = torch.zeros((2, 5, 4, 128), device=dev)
    pool = torch.zeros((6, 16, 2, 128), device=dev)
    pool8 = torch.zeros((6, 16, 2, 128), device=dev, dtype=torch.int8)
    table = torch.zeros((2, 3), device=dev, dtype=torch.int32)
    pos = torch.zeros((2,), device=dev, dtype=torch.int32)
    with pytest.raises(ValueError, match="Sq must be >= 2"):
        fa.paged_flash_verify(q1, pool, pool, table, pos)
    with pytest.raises(ValueError, match="Sq must be 1"):
        fa.paged_flash_decode(q5, pool, pool, table, pos)
    with pytest.raises(ValueError, match="int8 pages with scales"):
        fa.paged_flash_verify(q5, pool8, pool8, table, pos)
    bad = torch.zeros((6, 2, 16), device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="scale pages"):
        fa.paged_flash_decode(q1, pool8, pool8, table, pos, k_scale=bad,
                              v_scale=bad)


def test_tiny_server_kernels_match_reference(dev):
    """A tiny bf16 model served twice on the card, kernels vs the plain
    reference path: both kernels launch, first tokens agree."""
    from tpushare_torch.models import paged
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab_size=1000, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, head_dim=128,
                               d_ff=512)
    params = tt.init_params(0, cfg)
    prompts = [np.arange(5 + 11 * i) % cfg.vocab_size for i in range(3)]
    out = {}
    for impl in ("auto", "reference"):
        fa.flash_attention.launches = fa.paged_flash_decode.launches = 0
        srv = paged.PagedSlotServer(params, cfg, n_slots=4, n_blocks=64,
                                    prefix_cache=True, attn_impl=impl)
        firsts = []
        for p in prompts:
            slot = srv.admit_start(p)
            firsts.append(srv.admit_step(slot))
        steps = [srv.step() for _ in range(4)]
        out[impl] = (firsts, steps, fa.flash_attention.launches,
                     fa.paged_flash_decode.launches)
    assert out["auto"][2] > 0 and out["auto"][3] > 0
    assert out["reference"][2] == 0 and out["reference"][3] == 0
    assert out["auto"][0] == out["reference"][0]


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tiny_spec_fused_server_kernels_match_reference(dev, kv_quant):
    """A tiny bf16 model with an int8-self draft (and int8 pools): fused
    admission ticks and speculative rounds through the kernels vs the
    plain reference path. Every kernel variant of the path launches,
    the reference launches none, every round emits to every slot."""
    from tpushare_torch.models import paged, quant
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab_size=1000, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, head_dim=128,
                               d_ff=512)
    params = tt.init_params(0, cfg)
    draft = (quant.quantize_params(params, cfg), cfg)
    prompts = [np.arange(5 + 11 * i) % cfg.vocab_size for i in range(2)]
    long = np.arange(70) % cfg.vocab_size
    counters = [(fa.flash_attention, "launches"),
                (fa.paged_flash_decode, "launches"),
                (fa.paged_flash_verify,
                 "launches_int8" if kv_quant else "launches")]
    out = {}
    for impl in ("auto", "reference"):
        for fn, attr in counters:
            setattr(fn, attr, 0)
        srv = paged.PagedSlotServer(
            params, cfg, n_slots=4, n_blocks=64, prefix_cache=True,
            attn_impl=impl, kv_quant=kv_quant, speculative_draft=draft,
            gamma=2, draft_layers_hook=quant.dequant_hook(cfg))
        for p in prompts:
            srv.admit(p)
        slot = srv.admit_start(long, chunk_tokens=32)
        while slot in srv._admissions:
            srv.step(prefill_work=slot)
        rounds = [srv.step() for _ in range(3)]
        out[impl] = ([getattr(fn, a) for fn, a in counters], rounds)
    assert all(n > 0 for n in out["auto"][0]), out["auto"][0]
    assert out["reference"][0] == [0, 0, 0]
    assert all(len(r) == 3 for r in out["auto"][1])


def _assert_gate(got, want):
    """The per-element gate of chip_smoke.py, for f32 results of bf16 or
    f32 inputs (unnormalized accumulators and gradients): both sides sum
    the same f32 products in other orders."""
    d = (got.float() - want.float()).abs()
    lim = 2.0 ** -7 * want.float().abs() + 1e-5
    assert bool((d <= lim).all()), (d / lim).max().item()


# (B, Sq, Sk, H, Hkv, D, q_offset, k_offset, window, softcap)
CHUNK_CASES = [
    (1, 128, 128, 8, 4, 256, 0, 0, None, None),
    (2, 70, 200, 4, 2, 128, 150, 0, None, None),
    (1, 64, 96, 8, 8, 128, 192, 96, 40, 30.0),
    (1, 100, 64, 8, 4, 256, 300, 200, None, 50.0),
    (1, 64, 64, 4, 1, 128, 0, 64, None, None),       # wholly future
    (1, 33, 130, 32, 8, 128, 260, 140, 100, None),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,qo,ko,window,softcap",
                         CHUNK_CASES)
def test_flash_partial_vs_plain(dev, dtype, B, Sq, Sk, H, Hkv, D, qo, ko,
                                window, softcap):
    g = torch.Generator(device=dev).manual_seed(10)
    q = _rand(g, B, Sq, H, D, dtype=dtype, dev=dev)
    k = _rand(g, B, Sk, Hkv, D, dtype=dtype, dev=dev)
    v = _rand(g, B, Sk, Hkv, D, dtype=dtype, dev=dev)
    kw = dict(q_offset=qo, k_offset=ko, window=window, attn_softcap=softcap)
    before = fa.flash_attention_partial.launches
    got = fa.flash_attention_partial(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_partial.launches == before + 1
    want = fa.flash_attention_partial_plain(q, k, v, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        _assert_gate(a, b)
    if ko >= qo + Sq:        # a chunk wholly in the future: empty, no NaN
        assert float(got[2].abs().max()) == 0.0
        assert bool((got[1] == attn_mod.NEG_INF).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,qo,ko,window,softcap",
                         CHUNK_CASES)
def test_flash_bwd_vs_plain(dev, dtype, B, Sq, Sk, H, Hkv, D, qo, ko,
                            window, softcap):
    """The gradient of q against one chunk, from the lse and dsum of
    attention over every key up to the queries (the chunk is the tail
    of that range, so its keys may attend or not)."""
    g = torch.Generator(device=dev).manual_seed(11)
    q = _rand(g, B, Sq, H, D, dtype=dtype, dev=dev)
    k = _rand(g, B, ko + Sk, Hkv, D, dtype=dtype, dev=dev)
    v = _rand(g, B, ko + Sk, Hkv, D, dtype=dtype, dev=dev)
    do = _rand(g, B, Sq, H, D, dtype=dtype, dev=dev)
    kw = dict(q_offset=qo, window=window, attn_softcap=softcap)
    acc, m, l = fa.flash_attention_partial_plain(q, k, v, **kw)
    out = acc / l.clamp(min=1e-30).transpose(1, 2)[..., None]
    lse, dsum = m + torch.log(l), fa.softmax_dsum(do, out)
    ck, cv = k[:, ko:].contiguous(), v[:, ko:].contiguous()
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, ck, cv, do, lse, dsum, k_offset=ko, **kw)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = fa.flash_attention_bwd_plain(q, ck, cv, do, lse, dsum,
                                        k_offset=ko, **kw)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert bool(torch.isfinite(a).all())
        _assert_gate(a, b)


@pytest.mark.parametrize("window,softcap", [(None, None), (48, 30.0)])
def test_flash_attention_grad_vs_autograd_reference(dev, window, softcap):
    """Autograd through flash_attention (prefill kernel + gradient
    kernel) against autograd through mha_reference, f32 on the card."""
    g = torch.Generator(device=dev).manual_seed(12)
    shapes = [(1, 96, 8, 128), (1, 160, 2, 128), (1, 160, 2, 128)]
    x = [_rand(g, *s, dtype=torch.float32, dev=dev).requires_grad_()
         for s in shapes]
    do = _rand(g, *shapes[0], dtype=torch.float32, dev=dev)
    kw = dict(q_offset=64, window=window, attn_softcap=softcap)
    out = fa.flash_attention(*x, **kw)
    grads = torch.autograd.grad(out, x, do)
    ref = attn_mod.mha_reference(*x, **kw)
    ref_grads = torch.autograd.grad(ref, x, do)
    _assert_close(out.detach(), ref.detach(), torch.float32)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4)


# Long bf16 cases for the tensor-core bodies (every main path runs bf16):
# many tiles, both head widths, GQA groups of 1, 2, 4 and 8, ragged
# lengths, q/k offsets, and windows that straddle a 64-key tile. The f32
# results (partial accumulator, gradients) are sums over up to 2048 rows
# and are held to chip_smoke.py's f32-sum gate (floor F32_SUM_FLOOR of
# the tensor's largest element, the 2^-7 relative term unchanged), the
# normalized bf16 output to the rule above.
# (B, Sq, Sk, H, Hkv, D, q_offset, window, softcap)
TC_PREFILL_CASES = [
    (1, 1024, 1024, 8, 8, 128, 0, None, None),
    (1, 2048, 2048, 8, 4, 256, 0, None, 50.0),
    (1, 1000, 1000, 16, 4, 128, 0, 100, None),
    (1, 1000, 2048, 32, 4, 128, 1048, None, 30.0),
    (2, 1024, 1024, 8, 1, 256, 0, 200, 50.0),
]
# (B, Sq, Sk, H, Hkv, D, q_offset, k_offset, window, softcap)
TC_CHUNK_CASES = [
    (1, 2048, 2048, 8, 8, 128, 2048, 0, None, None),
    (1, 2048, 2048, 8, 4, 256, 2048, 2048, None, 50.0),
    (1, 1000, 1024, 16, 4, 128, 1000, 500, 300, None),
    (1, 1024, 1000, 32, 4, 128, 3000, 1500, None, 30.0),
    (1, 1024, 1024, 8, 1, 256, 1024, 1024, 200, 50.0),
]


def _assert_sum_gate(got, want):
    import chip_smoke
    cmp = chip_smoke.compare(got, want, chip_smoke.F32_SUM_FLOOR)
    assert cmp["ulp_ratio"] <= 1.0, cmp


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,q_offset,window,softcap",
                         TC_PREFILL_CASES)
def test_flash_prefill_tc_long_vs_plain(dev, B, Sq, Sk, H, Hkv, D, q_offset,
                                        window, softcap):
    g = torch.Generator(device=dev).manual_seed(13)
    q = _rand(g, B, Sq, H, D, dtype=torch.bfloat16, dev=dev)
    k = _rand(g, B, Sk, Hkv, D, dtype=torch.bfloat16, dev=dev)
    v = _rand(g, B, Sk, Hkv, D, dtype=torch.bfloat16, dev=dev)
    kw = dict(q_offset=q_offset, window=window, attn_softcap=softcap)
    got, lse = fa._flash_launch(q, k, v, scale=None, with_lse=True, **kw)
    want = attn_mod.mha_reference(q, k, v, **kw)
    _assert_close(got, want, torch.bfloat16)
    acc, m, l = fa.flash_attention_partial_plain(q, k, v, **kw)
    _assert_sum_gate(lse, m + torch.log(l))


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,qo,ko,window,softcap",
                         TC_CHUNK_CASES)
def test_flash_partial_tc_long_vs_plain(dev, B, Sq, Sk, H, Hkv, D, qo, ko,
                                        window, softcap):
    g = torch.Generator(device=dev).manual_seed(14)
    q = _rand(g, B, Sq, H, D, dtype=torch.bfloat16, dev=dev)
    k = _rand(g, B, Sk, Hkv, D, dtype=torch.bfloat16, dev=dev)
    v = _rand(g, B, Sk, Hkv, D, dtype=torch.bfloat16, dev=dev)
    kw = dict(q_offset=qo, k_offset=ko, window=window, attn_softcap=softcap)
    got = fa.flash_attention_partial(q, k, v, **kw)
    want = fa.flash_attention_partial_plain(q, k, v, **kw)
    for a, b in zip(got, want):
        _assert_sum_gate(a, b)


def _bwd_long_inputs(dev, B, Sq, Sk, H, Hkv, D, qo, ko, window, softcap):
    """q against the chunk k[ko:], with the lse and dsum of attention over
    every key up to the queries (as test_flash_bwd_vs_plain)."""
    g = torch.Generator(device=dev).manual_seed(15)
    q = _rand(g, B, Sq, H, D, dtype=torch.bfloat16, dev=dev)
    k = _rand(g, B, ko + Sk, Hkv, D, dtype=torch.bfloat16, dev=dev)
    v = _rand(g, B, ko + Sk, Hkv, D, dtype=torch.bfloat16, dev=dev)
    do = _rand(g, B, Sq, H, D, dtype=torch.bfloat16, dev=dev)
    kw = dict(q_offset=qo, window=window, attn_softcap=softcap)
    acc, m, l = fa.flash_attention_partial_plain(q, k, v, **kw)
    out = acc / l.clamp(min=1e-30).transpose(1, 2)[..., None]
    lse, dsum = m + torch.log(l), fa.softmax_dsum(do, out)
    ck, cv = k[:, ko:].contiguous(), v[:, ko:].contiguous()
    return (q, ck, cv, do, lse, dsum), dict(k_offset=ko, **kw)


@pytest.mark.parametrize("B,Sq,Sk,H,Hkv,D,qo,ko,window,softcap",
                         TC_CHUNK_CASES)
def test_flash_bwd_tc_long_vs_plain(dev, B, Sq, Sk, H, Hkv, D, qo, ko,
                                    window, softcap):
    args, kw = _bwd_long_inputs(dev, B, Sq, Sk, H, Hkv, D, qo, ko, window,
                                softcap)
    got = fa.flash_attention_bwd(*args, **kw)
    want = fa.flash_attention_bwd_plain(*args, **kw)
    for a, b in zip(got, want):
        assert bool(torch.isfinite(a).all())
        _assert_sum_gate(a, b)


@pytest.mark.parametrize("case", [TC_CHUNK_CASES[2], TC_CHUNK_CASES[4]])
def test_flash_bwd_is_deterministic(dev, case):
    """Two passes and no float atomics: the gradient of the same inputs is
    bit-equal run to run (the ring returns identical dk/dv to every
    owner only so)."""
    args, kw = _bwd_long_inputs(dev, *case)
    first = fa.flash_attention_bwd(*args, **kw)
    second = fa.flash_attention_bwd(*args, **kw)
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_partial_and_bwd_wrappers_raise(dev):
    q = torch.zeros((1, 4, 2, 128), device=dev)
    with pytest.raises(TypeError, match="Python ints"):
        fa.flash_attention_partial(q, q, q, k_offset=torch.tensor(0))
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention_partial(q[..., :64].contiguous(),
                                   q[..., :64].contiguous(),
                                   q[..., :64].contiguous())
    lse = torch.zeros((1, 2, 4), device=dev)
    with pytest.raises(ValueError, match="dout must match q"):
        fa.flash_attention_bwd(q, q, q, q.bfloat16(), lse, lse)
    with pytest.raises(ValueError, match="lse must be f32"):
        fa.flash_attention_bwd(q, q, q, q, lse.double(), lse)


def test_ring_and_spmd_steps_across_cards(dev, tmp_path):
    """The ring over NCCL, one card per rank (4 ranks on four cards, 2 on
    two), through the kernels: ring_attention_sharded's output and q/k/v
    gradients against the single-card flash_attention through its
    autograd Function. Then forward under pctx.sp and 2 SGD / 2 AdamW
    SPMD steps of a small f32 Gemma-2-style model (head_dim 128; dp2 x sp2
    on four cards, dp1 x sp2 on two) against the single-card steps; then
    the same with Ulysses (sp_impl="a2a": the attention case, 2 SGD and
    2 AdamW steps).
    Tolerances, f32 on both sides, which sum the same products in other
    orders (per hop, per shard): attention 1e-4 rel + 1e-5 abs, logits
    1e-5 rel + 1e-4 abs, losses 1e-5 rel, parameters 2e-5 abs."""
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs (the ring's NCCL "
                    "point-to-point path)")
    import torch_spawn
    from tpushare_torch.models import training
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.ops import _build
    _build.build_all(("flash_prefill", "flash_bwd"))   # before ranks load
    world = 4 if n >= 4 else 2
    rng = np.random.default_rng(20)
    S, H, Hkv, D = 256 * world, 8, 2, 128
    arrays = [rng.normal(size=s).astype(np.float32) for s in
              ((1, S, H, D), (1, S, Hkv, D), (1, S, Hkv, D), (1, S, H, D))]
    kw = dict(window=300, attn_softcap=30.0)
    got = torch_spawn.run_ranks(
        torch_spawn.ring_worker, world, tmp_path,
        dict(zip(("card_q", "card_k", "card_v", "card_do"), arrays)),
        [("card", kw)], backend="nccl", timeout=300)
    q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
               for a in arrays[:3])
    out = fa.flash_attention(q, k, v, **kw)
    out.backward(torch.tensor(arrays[3], device=dev))
    for name, want in (("out", out), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
        np.testing.assert_allclose(got[f"card_{name}"],
                                   want.detach().cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)

    cfg = tt.TransformerConfig(
        vocab_size=1000, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, act="gelu", norm_offset=1.0,
        embed_scale=True, sliding_window=100, alternate_sliding=True,
        attn_softcap=30.0, final_softcap=20.0, post_norms=True,
        dtype=torch.float32)
    params = tt.init_params(0, cfg, device="cpu")
    flat = torch_spawn.flatten(params)
    mu = {k_: rng.normal(size=a.shape).astype(np.float32) * 1e-2
          for k_, a in flat.items()}
    nu = {k_: rng.uniform(1e-4, 4e-4, size=a.shape).astype(np.float32)
          for k_, a in flat.items()}
    tokens = rng.integers(0, cfg.vocab_size, (2, 256 + 1))
    inputs = {"tokens": tokens, "count": np.int32(4),
              **{f"p/{k_}": a for k_, a in flat.items()},
              **{f"mu/{k_}": a for k_, a in mu.items()},
              **{f"nu/{k_}": a for k_, a in nu.items()}}
    sizes = {"dp": 2, "sp": 2} if world == 4 else {"sp": 2}
    lr, wd = 0.05, 0.01
    got = torch_spawn.run_ranks(torch_spawn.train_worker, world, tmp_path,
                                inputs, cfg, sizes, lr, 2, wd,
                                backend="nccl", timeout=300)
    tok = torch.tensor(tokens, device=dev)
    p = torch_spawn.unflatten(inputs, "p/", dev)
    with torch.no_grad():
        logits, _ = tt.forward(p, tok[:, :-1], cfg)
    np.testing.assert_allclose(got["logits"], logits.cpu().numpy(),
                               rtol=1e-5, atol=1e-4)
    for s in range(2):
        p, loss = training.sgd_train_step(p, tok, cfg, lr=lr)
        np.testing.assert_allclose(got[f"sgd_loss{s}"], loss.item(),
                                   rtol=1e-5)
    want = torch_spawn.flatten(p)
    for k_, a in want.items():
        np.testing.assert_allclose(got[f"sgd/{k_}"], a, rtol=0, atol=2e-5)
    p = torch_spawn.unflatten(inputs, "p/", dev)
    state = {"mu": torch_spawn.unflatten(inputs, "mu/", dev),
             "nu": torch_spawn.unflatten(inputs, "nu/", dev),
             "count": torch.tensor(4, dtype=torch.int32, device=dev)}
    for s in range(2):
        p, state, loss = training.adamw_train_step(p, state, tok, cfg, lr=lr,
                                                   weight_decay=wd)
        np.testing.assert_allclose(got[f"adamw_loss{s}"], loss.item(),
                                   rtol=1e-5)
    want = torch_spawn.flatten(p)
    for k_, a in want.items():
        np.testing.assert_allclose(got[f"adamw/{k_}"], a, rtol=0, atol=2e-5)
    assert int(got["adamw_count"]) == 6

    # Ulysses (sp_impl="a2a") over NCCL: the attention case above, then
    # the same SGD steps and AdamW steps (no weight decay), each against
    # the single card, at the same tolerances.
    got = torch_spawn.run_ranks(
        torch_spawn.ulysses_worker, world, tmp_path,
        dict(zip(("card_q", "card_k", "card_v", "card_do"), arrays)),
        [("card", kw)], backend="nccl", timeout=300)
    q, k, v = (torch.tensor(a, device=dev, requires_grad=True)
               for a in arrays[:3])
    out = fa.flash_attention(q, k, v, **kw)
    out.backward(torch.tensor(arrays[3], device=dev))
    for name, want in (("out", out), ("dq", q.grad), ("dk", k.grad),
                       ("dv", v.grad)):
        np.testing.assert_allclose(got[f"card_{name}"],
                                   want.detach().cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
    got = torch_spawn.run_ranks(torch_spawn.a2a_train_worker, world,
                                tmp_path, inputs, cfg, sizes, lr, 2,
                                backend="nccl", timeout=300)
    p = torch_spawn.unflatten(inputs, "p/", dev)
    pa = torch_spawn.unflatten(inputs, "p/", dev)
    state = {"mu": torch_spawn.unflatten(inputs, "mu/", dev),
             "nu": torch_spawn.unflatten(inputs, "nu/", dev),
             "count": torch.tensor(4, dtype=torch.int32, device=dev)}
    for s in range(2):
        p, loss = training.sgd_train_step(p, tok, cfg, lr=lr)
        np.testing.assert_allclose(got[f"sgd_loss{s}"], loss.item(),
                                   rtol=1e-5)
        pa, state, loss = training.adamw_train_step(pa, state, tok, cfg,
                                                    lr=lr)
        np.testing.assert_allclose(got[f"adamw_loss{s}"], loss.item(),
                                   rtol=1e-5)
    for prefix, tree in (("sgd/", p), ("adamw/", pa)):
        for k_, a in torch_spawn.flatten(tree).items():
            np.testing.assert_allclose(got[prefix + k_], a, rtol=0,
                                       atol=2e-5)


def _multi_card_inputs(rng, cfg):
    """The params (and a non-zero AdamW state) of ``cfg`` as numpy."""
    import torch_spawn
    from tpushare_torch.models import transformer as tt
    flat = torch_spawn.flatten(tt.init_params(0, cfg, device="cpu"))
    return flat, {
        "count": np.int32(4), **{f"p/{k}": a for k, a in flat.items()},
        **{f"mu/{k}": rng.normal(size=a.shape).astype(np.float32) * 1e-2
           for k, a in flat.items()},
        **{f"nu/{k}": rng.uniform(1e-4, 4e-4, size=a.shape).astype(
            np.float32) for k, a in flat.items()}}


def _two_cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs (the fsdp gathers and "
                    "the pipeline's point-to-point hops over NCCL)")
    from tpushare_torch.ops import _build
    _build.build_all(("flash_prefill", "flash_bwd"))  # before ranks load


def test_fsdp_steps_across_cards(dev, tmp_path):
    """fsdp 2 over NCCL, one card per rank: make_fsdp_train_step,
    make_fsdp_stream_train_step and make_fsdp_stream_adamw_step (from a
    non-zero state), 2 steps each, against the single-card steps; the
    AdamW run's flat checkpoint restored at fsdp 2, equal. f32 on both
    sides: losses 1e-5 rel, parameters 2e-5 abs."""
    _two_cards()
    import torch_spawn
    from tpushare_torch.models import training
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(
        vocab_size=1000, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, act="gelu", dtype=torch.float32)
    rng = np.random.default_rng(21)
    _, inputs = _multi_card_inputs(rng, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (2, 256 + 1))
    lr, wd = 0.05, 0.01
    got = torch_spawn.run_ranks(
        torch_spawn.fsdp_worker, 2, tmp_path, {"tokens": tokens, **inputs},
        cfg, {"fsdp": 2}, lr, 2, wd, str(tmp_path / "flat"),
        backend="nccl", timeout=300)
    assert bool(got["restored_equal"])
    tok = torch.tensor(tokens, device=dev)
    for name in ("plain", "stream"):
        p = torch_spawn.unflatten(inputs, "p/", dev)
        for s in range(2):
            p, loss = training.sgd_train_step(p, tok, cfg, lr=lr)
            np.testing.assert_allclose(got[f"{name}_loss{s}"], loss.item(),
                                       rtol=1e-5)
        for k, a in torch_spawn.flatten(p).items():
            np.testing.assert_allclose(got[f"{name}/{k}"], a, rtol=0,
                                       atol=2e-5)
    p = torch_spawn.unflatten(inputs, "p/", dev)
    state = {"mu": torch_spawn.unflatten(inputs, "mu/", dev),
             "nu": torch_spawn.unflatten(inputs, "nu/", dev),
             "count": torch.tensor(4, dtype=torch.int32, device=dev)}
    for s in range(2):
        p, state, loss = training.adamw_train_step(p, state, tok, cfg,
                                                   lr=lr, weight_decay=wd)
        np.testing.assert_allclose(got[f"adamw_loss{s}"], loss.item(),
                                   rtol=1e-5)
    for k, a in torch_spawn.flatten(p).items():
        np.testing.assert_allclose(got[f"adamw/{k}"], a, rtol=0, atol=2e-5)


def _port_sharded_inputs():
    """Tiny f32 dense and MoE trees (and the MoE's int8 tree) from the
    port's own init, for the sharded serving workers; head_dim 128, a
    width the attention kernels take."""
    import dataclasses
    import torch_spawn
    from tpushare_torch.models import moe, quant
    from tpushare_torch.models import transformer as tt
    tcfg = dataclasses.replace(tt.tiny(remat=False, head_dim=128),
                               dtype=torch.float32)
    mcfg = dataclasses.replace(moe.tiny(remat=False, head_dim=128),
                               dtype=torch.float32)
    tp_ = tt.init_params(0, tcfg, device="cpu")
    mp_ = moe.init_params(0, mcfg, device="cpu")
    inp = {}
    for name, cfg in (("tcfg", tcfg), ("mcfg", mcfg)):
        fields = {f.name: getattr(cfg, f.name)
                  for f in dataclasses.fields(cfg) if f.name != "dtype"}
        inp[name] = np.array(json.dumps(fields))
    for prefix, tree in (("tf/", tp_), ("moe/", mp_),
                         ("moeq/", quant.quantize_params(mp_, mcfg))):
        inp.update(torch_spawn.flatten(tree, prefix))
    return inp, tcfg, tp_, mcfg, mp_


@pytest.mark.parametrize("sizes,families", [
    ({"tp": 2}, ["dense_tp", "paged_tp", "paged_spec_tp"]),
    ({"tp": 2, "ep": 2}, ["paged_moe_eptp", "moe_rows_eptp"])])
def test_sharded_serving_across_cards(dev, tmp_path, sizes, families):
    """tp=2 (2+ cards) and ep2 x tp2 (4+ cards) over NCCL, one card per
    rank: tests/test_torch_sharded_serving.py's families through its
    ``_drive`` schedule, the kernels launched at the per-rank head and
    expert counts, against one-card twins on the same tiny f32 weights:
    streams equal, every rank's equal to rank 0's."""
    world = int(np.prod(list(sizes.values())))
    if torch.cuda.device_count() < world:
        pytest.skip(f"needs {world} or more NVIDIA GPUs (one per rank of "
                    f"{sizes} over NCCL)")
    from tpushare_torch.ops import _build
    _build.build_all()                               # before ranks load
    import torch_spawn
    from tpushare_torch.models import moe, serving
    from tpushare_torch.models.paged import PagedSlotServer
    inp, tcfg, tp_, mcfg, mp_ = _port_sharded_inputs()
    got = torch_spawn.run_ranks(
        torch_spawn.sharded_serving_worker, world, tmp_path, inp, sizes,
        families, (), backend="nccl", timeout=300)
    res = json.loads(str(got["res"]))
    tp_, mp_ = (torch_spawn.unflatten(torch_spawn.flatten(t), "", dev)
                for t in (tp_, mp_))
    twins = {
        "dense_tp": lambda: serving.SlotServer(tp_, tcfg, n_slots=3,
                                               max_len=96, device=dev),
        "paged_tp": lambda: PagedSlotServer(tp_, tcfg, n_slots=3,
                                            n_blocks=64, block_size=4,
                                            device=dev),
        "paged_spec_tp": lambda: PagedSlotServer(
            tp_, tcfg, n_slots=3, n_blocks=96, block_size=4,
            speculative_draft=(tp_, tcfg), gamma=2, device=dev),
        "paged_moe_eptp": lambda: PagedSlotServer(
            mp_, mcfg, n_slots=3, n_blocks=64, block_size=4,
            forward_fn=moe.paged_forward, device=dev),
        "moe_rows_eptp": lambda: moe.MoESlotServer(
            mp_, mcfg, n_slots=3, max_len=96, device=dev)}
    for name in families:
        vocab = (mcfg if "moe" in name else tcfg).vocab_size
        with torch.inference_mode():
            want = torch_spawn._drive(twins[name](),
                                      torch_spawn._prompt(7, 21, vocab),
                                      vocab)
        assert res[name] == json.loads(json.dumps(list(want))), name
        assert res[name + "/ranks_equal"] is True


def test_pipeline_schedules_across_cards(dev, tmp_path):
    """pp 2 over NCCL, one stage per card: one SGD step of GPipe, 1F1B
    and interleaved (2 chunks), and one 1F1B AdamW step from a non-zero
    state, against the single-card steps on the whole batch; then the
    MoE pipeline (psum, SGD and AdamW) against the per-microbatch
    objective. f32: losses 1e-5 rel, parameters 2e-5 abs."""
    _two_cards()
    import torch_spawn
    from tpushare_torch.models import moe, training
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(
        vocab_size=1000, d_model=256, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=128, d_ff=512, act="gelu", sliding_window=100,
        alternate_sliding=True, attn_softcap=30.0, dtype=torch.float32)
    rng = np.random.default_rng(22)
    _, inputs = _multi_card_inputs(rng, cfg)
    tokens = rng.integers(0, cfg.vocab_size, (4, 256 + 1))
    lr, wd = 0.05, 0.01
    got = torch_spawn.run_ranks(
        torch_spawn.pp_worker, 2, tmp_path, {"tokens": tokens, **inputs},
        cfg, {"pp": 2}, 2, lr, wd, ("gpipe", "1f1b", "interleaved"),
        backend="nccl", timeout=300)
    tok = torch.tensor(tokens, device=dev)
    p, loss = training.sgd_train_step(
        torch_spawn.unflatten(inputs, "p/", dev), tok, cfg, lr=lr)
    for sched in ("gpipe", "1f1b", "interleaved"):
        np.testing.assert_allclose(got[f"{sched}_loss"], loss.item(),
                                   rtol=1e-5)
        for k, a in torch_spawn.flatten(p).items():
            np.testing.assert_allclose(got[f"{sched}/{k}"], a, rtol=0,
                                       atol=2e-5)
    state = {"mu": torch_spawn.unflatten(inputs, "mu/", dev),
             "nu": torch_spawn.unflatten(inputs, "nu/", dev),
             "count": torch.tensor(4, dtype=torch.int32, device=dev)}
    p, state, loss = training.adamw_train_step(
        torch_spawn.unflatten(inputs, "p/", dev), state, tok, cfg, lr=lr,
        weight_decay=wd)
    np.testing.assert_allclose(got["adamw_loss"], loss.item(), rtol=1e-5)
    for k, a in torch_spawn.flatten(p).items():
        np.testing.assert_allclose(got[f"adamw/{k}"], a, rtol=0, atol=2e-5)

    mcfg = moe.MoEConfig(vocab_size=1000, d_model=256, n_layers=4,
                         n_heads=4, n_kv_heads=2, head_dim=128, d_ff=512,
                         n_experts=4, top_k=2, dtype=torch.float32,
                         remat=False)
    mflat = torch_spawn.flatten(moe.init_params(0, mcfg, device="cpu"))
    minputs = {"tokens": tokens, "count": np.int32(4),
               **{f"m/p/{k}": a for k, a in mflat.items()},
               **{f"m/mu/{k}": np.zeros_like(a) for k, a in mflat.items()},
               **{f"m/nu/{k}": np.zeros_like(a) for k, a in mflat.items()}}
    got = torch_spawn.run_ranks(
        torch_spawn.moe_pp_worker, 2, tmp_path, minputs, [("m", mcfg)],
        {"pp": 2}, 2, lr, wd, backend="nccl", timeout=300)
    mp = torch_spawn.unflatten(minputs, "m/p/", dev)
    loss, g = training.value_and_grad(lambda q: torch.stack(
        [moe.lm_loss(q, tok[i * 2:(i + 1) * 2], mcfg)
         for i in range(2)]).mean(), mp)
    np.testing.assert_allclose(got["m/sgd_loss"], loss.item(), rtol=1e-5)
    want = training._sgd_update(mp, g, lr)
    for k, a in torch_spawn.flatten(want).items():
        np.testing.assert_allclose(got[f"m/sgd/{k}"], a, rtol=0, atol=2e-5)


def test_tiny_engine_on_the_card(dev):
    """A tiny bf16 engine on the card answers one HTTP request; its tick
    runs in inference mode on the engine thread, and both attention
    kernels launched from it."""
    import http.client
    import json
    from tpushare_torch.cli import serve as serve_mod
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab_size=1000, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, head_dim=128,
                               d_ff=512)
    eng = serve_mod.ServeEngine(tt.init_params(0, cfg), cfg, n_slots=2,
                                n_blocks=64, idle_sleep_s=0.001,
                                chaos_spec="")
    seen = []
    real = eng.srv.step_async

    def spy(*a, **kw):
        seen.append((torch.is_inference_mode_enabled(),
                     torch.cuda.current_device()))
        return real(*a, **kw)

    eng.srv.step_async = spy
    fa.flash_attention.launches = fa.paged_flash_decode.launches = 0
    httpd = serve_mod.serve(eng, port=0, timeout_s=120)
    try:
        conn = http.client.HTTPConnection("127.0.0.1",
                                          httpd.server_address[1],
                                          timeout=120)
        conn.request("POST", "/v1/completions",
                     json.dumps({"prompt": list(range(1, 40)),
                                 "max_tokens": 6}))
        resp = conn.getresponse()
        body = json.loads(resp.read())
        conn.close()
    finally:
        httpd.shutdown()
        eng.stop()
    assert resp.status == 200 and len(body["tokens"]) == 6
    assert all(0 <= t < cfg.vocab_size for t in body["tokens"])
    assert seen and all(inf for inf, _ in seen)
    assert fa.flash_attention.launches > 0
    assert fa.paged_flash_decode.launches > 0


@pytest.mark.parametrize("kv_quant", [False, True])
def test_host_tier_roundtrip_on_the_card(dev, kv_quant):
    """A tiny bf16 pool on the card demotes a chain to the page-locked
    host arena, promotes it back (host upload) and, after a second
    eviction, from a side-stream prefetch: the greedy streams equal a
    never-evicted server's, the arena is pinned, and the estimator's
    d2h and h2d rates come from the copies' CUDA events."""
    from tpushare_torch.models import kvtier, paged
    from tpushare_torch.models import transformer as tt
    cfg = tt.TransformerConfig(vocab_size=1000, d_model=256, n_layers=2,
                               n_heads=4, n_kv_heads=2, head_dim=128,
                               d_ff=512)
    params = tt.init_params(0, cfg)
    rng = np.random.default_rng(3)
    a = rng.integers(0, 1000, 53)
    fillers = [rng.integers(0, 1000, 53) for _ in range(8)]

    def mk(tier, nb):
        return paged.PagedSlotServer(params, cfg, n_slots=2, n_blocks=nb,
                                     block_size=16, prefix_cache=True,
                                     kv_quant=kv_quant, host_tier=tier)

    def decode(srv, slot, n=8):
        out = [int(srv.last_token[slot, 0])]
        while len(out) < n:
            out.append(srv.step()[slot])
        return out

    big = mk(None, 64)
    want = decode(big, big.admit(a))
    tier = kvtier.HostKvTier(16 << 20)
    srv = mk(tier, 12)
    assert tier.arena.buf.is_pinned()
    srv.evict(srv.admit(a))
    for f in fillers[:4]:
        srv.evict(srv.admit(f))
    slot = srv.admit(a)
    assert srv.last_cached_len == 48 and decode(srv, slot) == want
    srv.evict(slot)
    for f in fillers[4:]:
        srv.evict(srv.admit(f))
    staged = srv.prefetch_prefix(a)
    hits = tier.prefetch_hits
    slot = srv.admit(a)
    assert staged == 3 and tier.prefetch_hits - hits == 3
    assert decode(srv, slot) == want
    torch.cuda.synchronize()
    snap = tier.snapshot()
    assert snap["demotions"] > 0 and snap["promotions"] >= 6
    for ch in ("d2h", "h2d"):
        assert snap["crossover"]["channels"][ch]["bytes_per_s"] > 0


# -- the plugin's NVIDIA half (discovery, the in-pod memory guard) --------

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tenant_child(code, env):
    """Run ``code`` in a fresh interpreter (its own CUDA init) with the
    pod env ``env`` and no inherited card selection; its last stdout
    line, parsed as JSON."""
    child = {k: v for k, v in os.environ.items()
             if k not in ("CUDA_VISIBLE_DEVICES", "TPUSHARE_HBM_ENFORCE",
                          "CTPU_DISABLE")}
    child.update(env, PYTHONPATH=_REPO)
    out = subprocess.run([sys.executable, "-c", code], env=child, cwd=_REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_nvml_discovery_matches_torch(dev):
    """NVML's cards are torch's: count, uuids, generation, and NVML's
    total within the card's reserved memory above torch's total_memory; the
    ChainBackend cross-check reads torch and finds no disagreement."""
    from tpushare_torch.plugin.backend import ChainBackend, TorchBackend
    from tpushare_torch.plugin.devices import expand_devices
    from tpushare_torch.plugin.nvmldisc import NvmlBackend
    topo = NvmlBackend().probe()
    n = torch.cuda.device_count()
    assert topo.chip_count == n
    for c in topo.chips:
        props = torch.cuda.get_device_properties(c.index)
        assert c.uuid == f"GPU-{props.uuid}"
        assert 0 <= c.hbm_bytes - props.total_memory < 1 << 30
        assert c.device_path.startswith("/dev/nvidia")
    dm = expand_devices(topo)
    assert dm.units_per_chip == {c.index: c.hbm_bytes >> 30
                                 for c in topo.chips}
    chain = ChainBackend([NvmlBackend(), TorchBackend()])
    assert chain.probe() == topo
    assert chain.checked_against == "torch" and chain.disagreement is None


def test_memory_fraction_stops_an_allocation_past_the_grant(dev):
    """A tenant under a 2 GiB grant: walking 256 MiB allocations raises
    torch.OutOfMemoryError before its reserved bytes pass the grant;
    with CTPU_DISABLE=true the same walk passes it."""
    code = (
        "import json, torch\n"
        "from tpushare_torch.utils.tenant import apply_tenant_limits, "
        "tenant_device\n"
        "spec = apply_tenant_limits(enforce='off')\n"
        "dev = tenant_device()\n"
        "held, err = [], None\n"
        "try:\n"
        "    while len(held) < 12:\n"
        "        held.append(torch.ones(1 << 26, device=dev))\n"
        "except torch.OutOfMemoryError as e:\n"
        "    err = type(e).__name__\n"
        "print(json.dumps({'held': len(held) << 28, 'err': err,\n"
        "    'reserved': torch.cuda.memory_reserved(dev)}))\n")
    env = {"NVIDIA_VISIBLE_DEVICES": "0",
           "TPUSHARE_HBM_LIMIT_BYTES": str(2 << 30)}
    got = _tenant_child(code, env)
    assert got["err"] == "OutOfMemoryError"
    assert got["reserved"] <= 2 << 30 and got["held"] <= 2 << 30
    free = _tenant_child(code, dict(env, CTPU_DISABLE="true"))
    assert free["err"] is None and free["held"] == 12 << 28


def test_tenant_grant_mirrors_across_cards(dev):
    """In a bare process on a host of several cards, a grant of the last
    card is mirrored into CUDA_VISIBLE_DEVICES (as its UUID): torch then
    sees one card, the one NVML numbers as granted."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs 2 or more NVIDIA GPUs")
    from tpushare_torch.plugin.nvmldisc import Nvml, load_library
    with Nvml(load_library()) as nv:
        last = nv.count() - 1
        want = nv.uuid(nv.handle(last))
    code = (
        "import json, os, torch\n"
        "from tpushare_torch.utils.tenant import apply_tenant_limits\n"
        "apply_tenant_limits(enforce='off')\n"
        "print(json.dumps({'n': torch.cuda.device_count(), 'uuid': 'GPU-' "
        "+ str(torch.cuda.get_device_properties(0).uuid), 'cvd': "
        "os.environ.get('CUDA_VISIBLE_DEVICES')}))\n")
    got = _tenant_child(code, {"NVIDIA_VISIBLE_DEVICES": str(last)})
    assert got["n"] == 1
    assert got["cvd"] == want and got["uuid"] == want
