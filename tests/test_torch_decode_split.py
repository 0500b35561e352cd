"""The split-KV decode walk (tpushare_torch/csrc/decode_tile.cuh), on the
CPU: the host's split choice (``decode_splits``), an emulation of the
rule by which each block finds its piece of a slot's live range on the
device, and an emulation of the kernel's f32 arithmetic (per-split
partials, then their merge) held against the JAX reference kernels in
interpret mode.

Tolerance of the merge against JAX: 2e-5 abs, f32 throughout (the JAX
kernel sums its online softmax in its own tiles, the emulation in 32-row
tiles per split and then across splits: summation order only), the same
as the flash/paged paths of test_torch_ops.py.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

jfa = importlib.import_module("tpushare.ops.flash_attention")
tfa = importlib.import_module("tpushare_torch.ops.flash_attention")

ROWS = tfa.DECODE_TILE_ROWS
NEG = -1e30                       # the kernels' masked logit (TS_NEG_INF)
GLOBAL = 1 << 30                  # TS_GLOBAL_SPAN: window <= 0
MERGE_ATOL = 2e-5


# -- the host's split choice ---------------------------------------------

@pytest.mark.parametrize("sms", [132, 114])
@pytest.mark.parametrize("B", [1, 2, 5, 8, 16, 33, 64, 200])
@pytest.mark.parametrize("H,Hkv", [(8, 1), (32, 8), (8, 4), (4, 4),
                                   (24, 1), (16, 2)])
def test_decode_splits_properties(sms, B, H, Hkv):
    blocks = B * Hkv * -(-(H // Hkv) // tfa.DECODE_GROUP)
    for max_rows in (1, 31, 32, 33, 100, 2080, 8192, 16384):
        S = tfa.decode_splits(B, H, Hkv, max_rows, sms)
        tiles = -(-max_rows // ROWS)
        assert S >= 1
        assert S <= tiles                       # a tile per split at least
        if blocks >= sms:
            assert S == 1                       # the card is already full
        else:
            # About twice the SMs, no more (bounded scratch: at most
            # 24 x sms (slot, head, split) partials of D + 2 floats).
            assert blocks * S < 2 * sms + blocks
            assert B * H * S <= 24 * sms
            if tiles >= 2 * sms:
                assert blocks * S >= 2 * sms


def test_decode_splits_of_the_main_paths():
    """The counts chip_smoke.py reports: Gemma-2B (8 slots, one kv
    head), Llama-3-8B (8 slots, 8 kv heads), Gemma-2-2B rows (8 slots,
    4 kv heads, M 8192)."""
    assert tfa.decode_splits(8, 8, 1, 1024 * 16) == 33
    assert tfa.decode_splits(8, 32, 8, 256 * 16) == 5
    assert tfa.decode_splits(8, 8, 4, 8192) == 9
    assert tfa.decode_splits(34, 32, 8, 960) == 1


# -- the device's boundary rule, emulated --------------------------------

def live_range(p, window, *, bs=None, mb=None, M=None):
    """[a, z): Addr::range's range (PagedAddr's whole pages from the
    window floor to p, or RowAddr's rows), cut to the live positions
    p - window < t <= p."""
    w = window if window and window > 0 else GLOBAL
    if bs is not None:
        hi = min(max(p // bs + 1, 1), mb)
        lo = min(max((p - w + 1) // bs, 0), hi - 1)
        a, z = lo * bs, hi * bs
    else:
        a, z = max(p - w + 1, 0), min(p + 1, M)
    return max(a, p - w + 1), min(z, p + 1)


def pieces(a, z, S):
    """Split s's positions [lo_s, hi_s): tiles [s n / S, (s + 1) n / S)
    of the n tiles counted from a (decode_tile.cuh's comment)."""
    n = -(-(z - a) // ROWS) if z > a else 0
    out = []
    for s in range(S):
        j0, j1 = s * n // S, (s + 1) * n // S
        out.append((a + j0 * ROWS, min(a + j1 * ROWS, z)))
    return out


def kernel_rows(p, window, S, *, table=None, bs=None, M=None):
    """Each split's positions whose K/V rows the kernel reads."""
    mb = None if table is None else len(table)
    a, z = live_range(p, window, bs=bs, mb=mb, M=M)
    out = []
    for lo, hi in pieces(a, z, S):
        ts = range(lo, max(lo, hi))
        if table is not None:
            ts = [t for t in ts if table[t // bs] >= 0]
        out.append(list(ts))
    return out


def plain_live(p, window, *, table=None, bs=None, M=None):
    """The positions the plain versions keep."""
    n = M if table is None else len(table) * bs
    t = np.arange(n)
    keep = t <= p
    if window:
        keep &= t > p - window
    if table is not None:
        keep &= np.repeat(np.asarray(table) >= 0, bs)
    return set(t[keep].tolist())


PAGED_CASES = [
    # (pos, window, bs, table: pages allocated, -1 elsewhere), S
    (0, None, 16, [3, -1, -1, -1], 5),           # pos 0
    (5, None, 16, [7, -1, -1, -1], 3),           # inside the first tile
    (700, 100, 16, list(range(50)), 4),          # window floor mid-split
    (40, None, 16, [1, 2, 3, -1, -1], 33),       # more splits than tiles
    (300, None, 24, [4, -1, 6, 7, -1, 9, 10, 11, 12, 13, 14, 15, 16, -1],
     6),                                         # -1 pages inside, bs 24
    (95, None, 24, [-1, -1, -1, -1, -1], 4),     # an inactive slot
    (2079, None, 16, list(range(140)), 33),      # Gemma-2B's longest slot
    (4999, 1000, 24, list(range(300)), 17),      # window over bs-24 pages
    (-1, None, 16, [2, -1], 3),                  # no position at all
]


@pytest.mark.parametrize("p,window,bs,table,S", PAGED_CASES)
def test_paged_splits_cover_each_live_position_once(p, window, bs, table, S):
    got = kernel_rows(p, window, S, table=table, bs=bs)
    flat = [t for piece in got for t in piece]
    assert len(flat) == len(set(flat))                 # at most once
    assert set(flat) == plain_live(p, window, table=table, bs=bs)
    a, z = live_range(p, window, bs=bs, mb=len(table))
    for lo, hi in pieces(a, z, S):                     # whole tiles from a
        assert hi <= lo or (lo - a) % ROWS == 0


@pytest.mark.parametrize("p,window,M,S", [
    (0, None, 300, 9), (31, None, 300, 9), (32, None, 300, 9),
    (299, 100, 300, 9), (8191, 4096, 8192, 9), (7039, None, 8192, 11),
    (7040, 4096, 8192, 11), (6000, None, 8192, 264), (350, None, 300, 2),
])
def test_row_splits_cover_each_live_position_once(p, window, M, S):
    got = kernel_rows(p, window, S, M=M)
    flat = [t for piece in got for t in piece]
    assert len(flat) == len(set(flat))
    assert set(flat) == plain_live(p, window, M=M)
    n_live = len(flat)
    # Whole tiles: every non-empty split but the last holds a multiple
    # of 32 positions; splits past the last tile are empty.
    sizes = [len(piece) for piece in got]
    nonempty = [k for k in sizes if k]
    assert all(k % ROWS == 0 for k in nonempty[:-1])
    assert sum(sizes) == n_live


# -- the kernel's arithmetic, emulated in f32 -----------------------------

def split_partials(q, k, v, scale, softcap, S_rows):
    """One (slot, kv head)'s partials: q [g, D]; k, v [n, D] in position
    order; S_rows: each split's list of row indices into k, v. Returns
    per split (acc [g, D], m [g], l [g]) as the kernel writes them: an
    online softmax over 32-row tiles, an empty split m = NEG, l = 0."""
    out = []
    for idx in S_rows:
        g, D = q.shape
        acc = torch.zeros(g, D)
        m = torch.full((g,), NEG)
        l = torch.zeros(g)
        for t0 in range(0, len(idx), ROWS):
            sel = idx[t0:t0 + ROWS]
            s = (q * scale) @ k[sel].T                       # [g, r]
            if softcap:
                s = softcap * torch.tanh(s / softcap)
            m_new = torch.maximum(m, s.max(dim=1).values)
            alpha = torch.exp(m - m_new)
            pr = torch.exp(s - m_new[:, None])
            l = l * alpha + pr.sum(dim=1)
            acc = acc * alpha[:, None] + pr @ v[sel]
            m = m_new
        out.append((acc, m, l))
    return out


def merge(parts):
    """merge_kernel: M = max m_s; weights exp(m_s - M) (0 where l_s =
    0); out = sum acc_s w_s / L, 0 when L = 0."""
    M = torch.stack([m for _, m, _ in parts]).max(dim=0).values
    L = torch.zeros_like(M)
    o = torch.zeros_like(parts[0][0])
    for acc, m, l in parts:
        w = torch.where(l > 0, torch.exp(m - M), torch.zeros_like(M))
        L = L + l * w
        # A split of weight 0 is skipped: its accumulator is not read.
        o = o + torch.where(w[:, None] > 0, acc * w[:, None],
                            torch.zeros_like(acc))
    return torch.where(L[:, None] > 0, o / L.clamp(min=1e-30)[:, None],
                       torch.zeros_like(o))


def _np(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("S", [1, 3, 9])
@pytest.mark.parametrize("window,softcap", [(None, None), (40, 20.0)])
def test_row_merge_matches_jax_flash_decode(S, window, softcap):
    B, M, H, Hkv, D = 4, 256, 4, 2, 128
    g = H // Hkv
    q, k, v = _np(60, B, 1, H, D), _np(61, B, M, Hkv, D), _np(62, B, M, Hkv, D)
    pos = np.array([0, 37, 200, 255], np.int32)
    want = np.asarray(jfa.flash_decode(
        *map(jnp.asarray, (q, k, v, pos)), window=window,
        attn_softcap=softcap, block_k=128, interpret=True))
    got = np.zeros_like(want)
    scale = D ** -0.5
    for b in range(B):
        S_rows = kernel_rows(int(pos[b]), window, S, M=M)
        for h in range(Hkv):
            parts = split_partials(
                torch.from_numpy(q[b, 0, h * g:(h + 1) * g]),
                torch.from_numpy(k[b, :, h]), torch.from_numpy(v[b, :, h]),
                scale, softcap, S_rows)
            got[b, 0, h * g:(h + 1) * g] = merge(parts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MERGE_ATOL)


@pytest.mark.parametrize("S", [1, 4, 33])
@pytest.mark.parametrize("window,softcap", [(None, None), (20, 30.0)])
def test_paged_merge_matches_jax_paged_decode(S, window, softcap):
    """Ragged slots through a block table with a shared page (slots 0
    and 3) and -1 pages past each slot's end; then an inactive slot
    (all -1), whose output is 0 as in the port's plain version (the JAX
    kernel has no such slot in its own tests)."""
    B, H, Hkv, D, nb, bs, mb = 4, 8, 2, 128, 12, 16, 5
    g = H // Hkv
    pk, pv = _np(63, nb, bs, Hkv, D), _np(64, nb, bs, Hkv, D)
    q = _np(65, B, 1, H, D)
    table = np.array([[2, 7, 1, -1, -1], [0, -1, -1, -1, -1],
                      [5, 8, 6, 4, 9], [2, 10, -1, -1, -1]], np.int32)
    pos = np.array([40, 3, 77, 17], np.int32)
    want = np.asarray(jfa.paged_flash_decode(
        *map(jnp.asarray, (q, pk, pv, table, pos)), window=window,
        attn_softcap=softcap, interpret=True))
    got = np.zeros_like(want)
    for b in range(B):
        S_rows = kernel_rows(int(pos[b]), window, S, table=table[b], bs=bs)
        rows_of = lambda ts: [table[b, t // bs] * bs + t % bs for t in ts]
        S_idx = [rows_of(ts) for ts in S_rows]
        for h in range(Hkv):
            kf = torch.from_numpy(pk[:, :, h].reshape(nb * bs, D))
            vf = torch.from_numpy(pv[:, :, h].reshape(nb * bs, D))
            parts = split_partials(
                torch.from_numpy(q[b, 0, h * g:(h + 1) * g]), kf, vf,
                D ** -0.5, softcap, S_idx)
            got[b, 0, h * g:(h + 1) * g] = merge(parts).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=MERGE_ATOL)
    table[1] = -1
    idle = kernel_rows(int(pos[1]), window, S, table=table[1], bs=bs)
    parts = split_partials(torch.from_numpy(q[1, 0, :g]),
                           torch.zeros(nb * bs, D), torch.zeros(nb * bs, D),
                           D ** -0.5, softcap, idle)
    plain = tfa.paged_flash_decode_plain(*map(torch.from_numpy,
                                              (q, pk, pv, table, pos)))
    assert torch.equal(merge(parts), plain[1, 0, :g]) and \
        torch.all(plain[1] == 0)


def test_empty_splits_leave_the_merge_unchanged():
    """Padding a slot's walk with empty splits (m = NEG, l = 0) changes
    no bit of the merged output: the merge skips them."""
    g, D, n = 4, 128, 100
    q, k, v = (torch.from_numpy(_np(s, *sh)) for s, sh in
               ((66, (g, D)), (67, (n, D)), (68, (n, D))))
    few = kernel_rows(n - 1, None, 2, M=n)
    many = kernel_rows(n - 1, None, 40, M=n)
    assert sum(not piece for piece in many) > 30
    a = merge(split_partials(q, k, v, 0.1, None, few))
    b = merge(split_partials(q, k, v, 0.1, None, many))
    torch.testing.assert_close(a, b, rtol=0, atol=MERGE_ATOL)
    garbage = (torch.full((g, D), float("nan")), torch.full((g,), NEG),
               torch.zeros(g))
    c = merge(split_partials(q, k, v, 0.1, None, few) + [garbage])
    assert torch.equal(a, c)
