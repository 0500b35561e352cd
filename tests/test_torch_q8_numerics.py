"""How the tensor-core kernels of csrc/q8_expert.cu and csrc/paged_verify.cu
feed f32 operands to bf16 products, pinned on the CPU.

The int8 expert FFN runs x . Wg and x . Wu on bf16 tensor cores exactly
(bf16 x, int8 weights widened to bf16), but its down product takes the
f32 ff = act(g * sg) * (u * su), which must enter as bf16: the kernel
splits it into three bf16 terms (t0 = bf16(ff), t1 = bf16(ff - t0),
t2 = bf16(ff - t0 - t1)). At Mixtral-8x7B's widths (d_model 4096, d_ff
14336; 512 of Wd's output columns) on two experts with random int8
weights quantized per column, as chip_smoke.py makes them, and
chip_smoke.py's gate (``compare``):

- one rounding misses the gate by >100x (255x at C 8, 232x at C 64);
- two and three terms meet it;
- three flip fewer bf16 outputs than two (4 against 22 of 8,192 at C 8,
  21 against 147 of 65,536 at C 64).

On the card the kernel also reads its f32 sums from the tensor cores,
whose own rounding flips more outputs than this emulation shows, and
two terms carried Mixtral-8x7B's served logits past their gate there
(PERF.md §6), so the kernel takes three.

Paged verify over int8 pages moves the scales off the rows onto the
products: k_scale multiplies S's column after Q.K^T, v_scale multiplies
P's column before P is split into its three terms. Both reorderings,
emulated, are held against ``paged_flash_verify_plain``'s (int8 * scale)
rows under the same gate.

The products are emulated in f32: a bf16 term times an int8 value is
exact in f32. Each term of ff is its own product, summed after, as the
kernel accumulates one term's products after another's; the card sums in
yet another order, which the gates already allow.
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import chip_smoke

q8 = importlib.import_module("tpushare_torch.ops.q8_expert")
fa = importlib.import_module("tpushare_torch.ops.flash_attention")
attn_mod = importlib.import_module("tpushare_torch.ops.attention")
quant = importlib.import_module("tpushare_torch.models.quant")

E, DM, FD = 2, 4096, 14336        # Mixtral-8x7B's widths, two experts
# Wd's output columns kept: the rounding pinned here is the down
# product's over its FD-deep contraction, which the column count does
# not change; all 4096 would only cost memory and time.
DOUT = 512
TERMS = {"single": 1, "hilo": 2, "three": 3}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _terms(x, n):
    """The f32 operand as the kernel feeds it: its first n bf16 terms."""
    out, rest = [], x
    for _ in range(n):
        t = _bf16(rest)
        out.append(t)
        rest = rest - t
    return out


def _split(x, n):
    return sum(_terms(x, n))


def _normal(rng, *shape):
    return torch.tensor(rng.standard_normal(shape), dtype=torch.float32)


@functools.lru_cache(maxsize=None)
def _q8_readings(C):
    """({mode: compare(...) dict}, {mode: bf16 outputs that differ from
    the plain version's}) for a shared [C, DM] token block."""
    rng = np.random.default_rng(C)
    x = _normal(rng, C, DM).to(torch.bfloat16)
    got = {mode: [] for mode in TERMS}
    want = []
    for _ in range(E):    # one expert at a time keeps the f32 copies small
        w = []
        for shape, fan in (((DM, FD), DM), ((DM, FD), DM), ((FD, DOUT), FD)):
            wq, ws = quant.quantize_weight(
                (_normal(rng, *shape) / fan ** 0.5).to(torch.bfloat16))
            w += [wq[None], ws[None]]
        want.append(q8.q8_expert_ffn_reference(x, *w)[0])
        wg, sg, wu, su, wd, sd = (t[0] for t in w)
        xf = x.float()
        ff = q8._apply_act("silu", (xf @ wg.float()) * sg) \
            * ((xf @ wu.float()) * su)
        wdf = wd.float()
        for mode, n in TERMS.items():   # each term its own product
            y = sum(t @ wdf for t in _terms(ff, n))
            got[mode].append((y * sd).to(torch.bfloat16))
        del w, wg, wu, wd, wdf, ff
    want = torch.stack(want)
    cmp = {m: chip_smoke.compare(torch.stack(g), want)
           for m, g in got.items()}
    flips = {m: int((torch.stack(g) != want).sum()) for m, g in got.items()}
    return cmp, flips


@pytest.mark.parametrize("C", [8, 64])
def test_q8_one_bf16_rounding_fails_the_gate(C):
    got = _q8_readings(C)[0]["single"]
    assert got["ulp_ratio"] > 100.0, got


@pytest.mark.parametrize("mode", ["hilo", "three"])
@pytest.mark.parametrize("C", [8, 64])
def test_q8_split_stays_within_the_gate(C, mode):
    got = _q8_readings(C)[0][mode]
    assert got["ulp_ratio"] <= 1.0, got


@pytest.mark.parametrize("C", [8, 64])
def test_q8_three_terms_flip_fewer_bf16_outputs(C):
    flips = _q8_readings(C)[1]
    assert flips["three"] < flips["hilo"] < flips["single"], flips


def _paged_int8(rng, B, Sq, H, Hkv, D, bs, nb, mb, pos):
    """An int8 pool (kv_quantize of random rows, scales in the port's
    [nb, Hkv, bs] layout), slot b owning the pages through pos[b] + Sq -
    1, slots 0 and 2 sharing their first page; bf16 q."""
    k8, ks = quant.kv_quantize(_normal(rng, nb, bs, Hkv, D))
    v8, vs = quant.kv_quantize(_normal(rng, nb, bs, Hkv, D))
    table = np.full((B, mb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B):
        n = min(mb, (int(pos[b]) + Sq - 1) // bs + 1)
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[2, 0] = table[0, 0]
    q = _normal(rng, B, Sq, H, D).to(torch.bfloat16)
    return (q, k8, v8, torch.as_tensor(table),
            torch.as_tensor(np.asarray(pos, np.int32)),
            quant.scales_to_pool_layout(ks), quant.scales_to_pool_layout(vs))


def _verify_folded(q, k8, v8, table, pos, k_scale, v_scale, window, softcap):
    """paged_verify.cu's int8 arithmetic: S = (q . k8) * scale * k_scale
    of the column, the softmax on S, P times v_scale of the column split
    into three bf16 terms, times the int8 rows, over the unscaled row
    sum."""
    B, Sq, H, D = q.shape
    nb, bs, Hkv, _ = k8.shape
    mb, G = table.shape[1], H // Hkv
    safe = table.clamp(min=0).long()

    def rows(pool, scales):  # [B, K, Hkv, D] int8 values, [B, Hkv, K]
        return (pool[safe].float().reshape(B, mb * bs, Hkv, D),
                scales[safe].transpose(-1, -2).reshape(B, mb * bs, Hkv)
                .permute(0, 2, 1)[:, :, None, None, :])

    kd, ks = rows(k8, k_scale)
    vd, vs = rows(v8, v_scale)
    k_pos = torch.arange(mb * bs)[None, None, :]
    q_pos = (pos.long()[:, None] + torch.arange(Sq)[None, :])[..., None]
    keep = (table >= 0).repeat_interleave(bs, dim=1)[:, None, :] \
        & (k_pos <= q_pos)
    if window is not None:
        keep &= attn_mod.window_keep(q_pos, k_pos, window)
    qg = q.reshape(B, Sq, Hkv, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kd) * (D ** -0.5 * ks)
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    keep = keep[:, None, None]
    s = torch.where(keep, s, attn_mod.NEG_INF)
    p = torch.where(keep, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bkhd->bhgqd", _split(p * vs, 3), vd) \
        / l.clamp(min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D).to(q.dtype)


@pytest.mark.parametrize("Sq,H,Hkv,D,window,softcap", [
    (5, 32, 8, 128, None, None),        # Llama-3-8B spec verify
    (40, 32, 8, 128, None, None),
    (24, 8, 4, 256, 40, 50.0),          # Gemma-2: window and softcap
])
def test_verify_int8_scale_folds_stay_within_the_gate(Sq, H, Hkv, D, window,
                                                      softcap):
    rng = np.random.default_rng(Sq)
    bs, mb = 16, 12
    args = _paged_int8(rng, 3, Sq, H, Hkv, D, bs, 60, mb,
                       [3 * bs + 2, 7 * bs - 3, 10])
    q, k8, v8, table, pos, ks, vs = args
    want = fa.paged_flash_verify_plain(q, k8, v8, table, pos, window=window,
                                       attn_softcap=softcap, k_scale=ks,
                                       v_scale=vs)
    got = _verify_folded(*args, window, softcap)
    cmp = chip_smoke.compare(got, want)
    assert cmp["ulp_ratio"] <= 1.0, cmp
