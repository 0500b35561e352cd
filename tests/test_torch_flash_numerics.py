"""How the tensor-core attention kernels feed an f32 operand to a bf16
product, pinned on the CPU.

A bf16 tensor-core product takes both operands in bf16. The operand the
kernels compute in f32 — p in p.v and p^T.dout, ds in ds.k and ds^T.q —
must be rounded to enter it. csrc/flash_prefill.cu splits p into three
bf16 terms (t0 = bf16(x), t1 = bf16(x - t0), t2 = bf16(x - t0 - t1),
all 24 bits), csrc/flash_bwd.cu splits p and ds into two (~16 bits).
This test emulates the choices on the CPU in f32 and holds each against
the port's plain versions under chip_smoke.py's own gates (``compare``,
``ULP_REL``, ``ULP_FLOOR``, ``F32_SUM_FLOOR``), at a training-like shape
(S 2048, D 128, one head, causal, softcap 50, bf16 inputs):

- one rounding misses every gate (the normal-mode output by ~44x, the
  partial accumulator by ~11x, the gradients by 5-8x);
- two and three terms meet every gate;
- two terms flip more of the bf16 outputs than three (608 against 177 of
  262,144 here), flips that int8 KV pages downstream amplify;
- at a short length (two rows of 200, eight heads) the partial pass's
  unnormalized accumulator under the card tests' absolute 1e-5 floor
  (``compare`` without a floor of the max) needs three terms.

So a later "simplification" to fewer terms fails here before it fails on
the card. The products are emulated in f32 (bf16 times bf16 is exact in
f32; the card sums in another order, which the gates already allow).
"""

import functools
import importlib

import numpy as np
import pytest
import torch

import chip_smoke

fa = importlib.import_module("tpushare_torch.ops.flash_attention")
attn_mod = importlib.import_module("tpushare_torch.ops.attention")

S, D, CAP = 2048, 128, 50.0
OUTPUTS = ("out", "acc", "dv", "dk", "dq")
TERMS = {"single": 1, "hilo": 2, "three": 3}


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _split(x, n):
    """The f32 operand as the kernel feeds it: the sum of its first n
    bf16 terms."""
    out, rest = torch.zeros_like(x), x
    for _ in range(n):
        t = _bf16(rest)
        out, rest = out + t, rest - t
    return out


def _inputs(rng, *shapes):
    return [torch.tensor(rng.standard_normal(s),
                         dtype=torch.float32).to(torch.bfloat16)
            for s in shapes]


@functools.lru_cache(maxsize=None)
def _readings():
    """({(output, mode): compare(...) dict}, {mode: bf16 outputs that
    differ from the plain version's})."""
    q, k, v, do = _inputs(np.random.default_rng(0), *[(1, S, 1, D)] * 4)
    kw = dict(q_offset=0, window=None, attn_softcap=CAP)
    acc_w, m, l = fa.flash_attention_partial_plain(q, k, v, **kw)
    want = {"out": attn_mod.mha_reference(q, k, v, **kw), "acc": acc_w}
    lse = m + torch.log(l)
    dsum = fa.softmax_dsum(do, acc_w / l.transpose(1, 2)[..., None])
    want.update(zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
        q, k, v, do, lse, dsum, **kw)))

    # The kernels' f32 p and ds, as the plain versions form them.
    scale = D ** -0.5
    qf, kf, vf, dof = (x[0, :, 0].float() for x in (q, k, v, do))
    raw = (qf * scale) @ kf.T
    t = torch.tanh(raw / CAP)
    s = CAP * t
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    s = torch.where(keep, s, attn_mod.NEG_INF)
    mx = s.amax(dim=-1, keepdim=True)
    p_fwd = torch.where(keep, torch.exp(s - mx), 0.0)
    l_fwd = p_fwd.sum(dim=-1, keepdim=True)
    p = torch.where(keep, torch.exp(s - lse[0, 0][:, None]), 0.0)
    ds = p * (dof @ vf.T - dsum[0, 0][:, None]) * (1.0 - t * t)

    out, flips = {}, {}
    for mode, n in TERMS.items():
        acc = _split(p_fwd, n) @ vf
        got = {"acc": acc, "out": (acc / l_fwd).to(torch.bfloat16),
               "dv": _split(p, n).T @ dof,
               "dk": _split(ds, n).T @ qf * scale,
               "dq": _split(ds, n) @ kf * scale}
        for name in OUTPUTS:
            w = want[name].reshape(S, D)
            floor = None if name == "out" else chip_smoke.F32_SUM_FLOOR
            out[name, mode] = chip_smoke.compare(got[name].reshape(S, D), w,
                                                 floor)
        flips[mode] = int((got["out"].reshape(S, D)
                           != want["out"].reshape(S, D)).sum())
    return out, flips


@pytest.mark.parametrize("mode", ["hilo", "three"])
@pytest.mark.parametrize("name", OUTPUTS)
def test_split_stays_within_the_gate(name, mode):
    got = _readings()[0][name, mode]
    assert got["ulp_ratio"] <= 1.0, got


@pytest.mark.parametrize("name", OUTPUTS)
def test_one_bf16_rounding_fails_the_gate(name):
    got = _readings()[0][name, "single"]
    assert got["ulp_ratio"] > 1.0, got


def test_three_terms_flip_fewer_bf16_outputs():
    flips = _readings()[1]
    assert flips["three"] < flips["hilo"] < flips["single"], flips


def test_short_partial_accumulator_needs_three_terms():
    """The partial pass's (acc, m, l) at two rows of 200 queries and keys,
    eight heads over two kv heads, D 128: the unnormalized accumulator's
    elements near 0 meet the absolute 1e-5 floor only with three terms."""
    q, k, v = _inputs(np.random.default_rng(1), (2, 200, 8, 128),
                      (2, 200, 2, 128), (2, 200, 2, 128))
    kw = dict(q_offset=0, k_offset=0, window=None, attn_softcap=None)
    want = fa.flash_attention_partial_plain(q, k, v, **kw)[0]
    _, _, s, keep = fa._chunk_scores(q, k, scale=None, **kw)
    s = torch.where(keep, s, attn_mod.NEG_INF)
    p = torch.where(keep, torch.exp(s - s.amax(dim=-1, keepdim=True)), 0.0)
    ratio = {}
    for mode in ("hilo", "three"):
        acc = torch.einsum("bhgqk,bkhd->bqhgd", _split(p, TERMS[mode]),
                           v.float()).reshape(want.shape)
        ratio[mode] = chip_smoke.compare(acc, want)["ulp_ratio"]
    assert ratio["hilo"] > 1.0 >= ratio["three"], ratio


def test_gate_constants_are_the_cards():
    """The gates read here are chip_smoke.py's, unchanged."""
    assert chip_smoke.ULP_REL == 2.0 ** -7
    assert chip_smoke.ULP_FLOOR == 1e-5
    assert chip_smoke.F32_SUM_FLOOR == 1e-4
