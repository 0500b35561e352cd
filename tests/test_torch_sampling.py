"""The port's sampling (tpushare_torch.models.generate, TokenSampler)
and stochastic speculation cores (tpushare_torch.models.spec) against
the JAX package's, on the CPU.

- ``filter_logits`` equals JAX's EXACTLY (the same f32 division, the
  same -inf mask) on seeded rows with ties at the k-th value, for every
  row whose top-p cut lies at least 1e-4 away from p; the one boundary
  case (preceding mass within an ulp of p) may differ by that one token
  and no other.
- Laws, not bits, across frameworks (the generators differ): over
  2^15 draws the empirical law of ``sample_logits``, and of the token a
  round emits under ``spec_accept_core``, lies within TV 0.03 of
  ``softmax`` of JAX's ``filter_logits`` (the null TV of 2^15 draws
  over these vocabularies is ~0.01).
- ``draft_sample_core``'s law equals JAX's within 1e-6 (abs, f32).
- A draft law equal to the target's accepts every draft, with JAX's
  a_b; a poisoned verify row never accepts and a cut on it emits -1.
- A stochastic int8-self PagedSlotServer round keeps one fetch per
  round, reproduces for one seed and stays in the vocabulary.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import generate as jgen
from tpushare.models import spec as jspec
from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import generate as tgen
from tpushare_torch.models import paged as tpaged
from tpushare_torch.models import quant as tquant
from tpushare_torch.models import serving as tserving
from tpushare_torch.models import spec as tspec

N_DRAWS = 1 << 15
TV_BOUND = 0.03
LAW_ATOL = 1e-6
P_MARGIN = 1e-4


def _tied_rows(seed, B=16, V=64):
    """Half-integer logits: many exact ties, at the k-th value too."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-8, 9, (B, V)) * 0.5).astype(np.float32)


def _cut_margin(logits, temperature, top_k, top_p):
    """Per row, the distance of p from the nearest preceding mass the
    top-p rule compares against (f64, after the same top-k)."""
    x = logits.astype(np.float64) / temperature
    if top_k:
        kth = np.sort(x, -1)[:, ::-1][:, top_k - 1:top_k]
        x = np.where(x < kth, -np.inf, x)
    s = np.sort(x, -1)[:, ::-1]
    e = np.exp(s - s[:, :1])
    probs = e / e.sum(-1, keepdims=True)
    pre = np.cumsum(probs, -1) - probs
    return np.abs(pre - top_p).min(-1)


def _tv(draws, p, V):
    hist = np.bincount(np.asarray(draws), minlength=V) / len(draws)
    return 0.5 * np.abs(hist - p).sum(), hist


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, None, None), (0.7, 5, None), (1.3, None, 0.8),
    (0.8, 12, 0.9), (1.0, 64, 0.5), (0.5, 1, None)])
def test_filter_logits_equals_jax(temperature, top_k, top_p):
    logits = _tied_rows(int(temperature * 10) + (top_k or 0))
    if top_p is not None:
        keep = _cut_margin(logits, temperature, top_k, top_p) > P_MARGIN
        logits = logits[keep]
        assert len(logits) >= 8
    want = np.asarray(jgen.filter_logits(jnp.asarray(logits), temperature,
                                         top_k=top_k, top_p=top_p))
    got = tgen.filter_logits(torch.from_numpy(logits), temperature,
                             top_k=top_k, top_p=top_p).numpy()
    np.testing.assert_array_equal(got, want)
    if top_k and top_p is None:
        # Ties at the k-th value all survive: at least k kept per row.
        assert (np.isfinite(got).sum(-1) >= top_k).all()


def test_top_p_boundary_differs_by_at_most_the_boundary_token():
    """Preceding mass exactly p in exact arithmetic (0.5 + 0.25 at
    p = 0.75): f32 cumsum in either framework may land the third-ranked
    token on either side. The two kept sets may differ by that token
    alone."""
    logits = np.log(np.array([[0.5, 0.25, 0.125, 0.125]], np.float32))
    want = np.isfinite(np.asarray(jgen.filter_logits(
        jnp.asarray(logits), 1.0, top_p=0.75)))
    got = np.isfinite(tgen.filter_logits(
        torch.from_numpy(logits), 1.0, top_p=0.75).numpy())
    diff = np.nonzero(want[0] != got[0])[0].tolist()
    assert diff in ([], [2]), diff
    assert got[0, :2].all() and want[0, :2].all()


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, None, None), (0.8, 6, 0.9),
                          (1.2, None, 0.7)])
def test_sampled_law_matches_jax_filtered_softmax(temperature, top_k,
                                                  top_p):
    V = 24
    row = np.random.default_rng(7).normal(size=(1, V)).astype(np.float32)
    p = np.asarray(jax.nn.softmax(jgen.filter_logits(
        jnp.asarray(row), temperature, top_k=top_k, top_p=top_p)),
        np.float64)[0]
    gen = torch.Generator().manual_seed(3)
    draws = tgen.sample_logits(
        torch.from_numpy(row).expand(N_DRAWS, V), gen,
        temperature=temperature, top_k=top_k, top_p=top_p)
    tv, hist = _tv(draws.numpy(), p, V)
    assert tv < TV_BOUND, tv
    assert hist[p == 0].sum() == 0          # no draw of a masked token


def test_tv_bound_rejects_a_sampler_without_top_p():
    """The TV gate has power: draws that skip the top-p mask (the planted
    fault chip_smoke.py also runs) miss the filtered law by far more."""
    V = 24
    row = np.random.default_rng(7).normal(size=(1, V)).astype(np.float32)
    p = np.asarray(jax.nn.softmax(jgen.filter_logits(
        jnp.asarray(row), 1.2, top_p=0.7)), np.float64)[0]
    draws = tgen.sample_logits(torch.from_numpy(row).expand(N_DRAWS, V),
                               torch.Generator().manual_seed(3),
                               temperature=1.2)
    tv, _ = _tv(draws.numpy(), p, V)
    assert tv > 3 * TV_BOUND, tv


def test_greedy_ties_nan_and_seeded_stream():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert tgen.sample_logits(logits).tolist() == [1, 0]
    assert tserving.TokenSampler().pick(logits).tolist() == \
        np.asarray(jgen.sample_logits(jnp.asarray(logits.numpy()),
                                      None)).tolist()
    bad = logits.clone()
    bad[1, 2] = float("nan")
    for t in (0.0, 0.9):
        s = tserving.TokenSampler(temperature=t, top_k=3, seed=1)
        assert s.pick(bad).tolist()[1] == -1
    x = torch.randn(4, 50, generator=torch.Generator().manual_seed(0))

    def stream(seed):
        s = tserving.TokenSampler(temperature=1.0, top_p=0.9, seed=seed)
        return [s.pick(x).tolist() for _ in range(6)]

    assert stream(5) == stream(5)
    assert stream(5) != stream(6)


def test_draft_sample_core_law_equals_jax():
    dl = np.random.default_rng(9).normal(size=(6, 40)).astype(np.float32)
    kw = dict(temperature=0.9, top_k=10, top_p=0.85)
    _, want = jspec.draft_sample_core(jnp.asarray(dl), jax.random.PRNGKey(0),
                                      **kw)
    tok, got = tspec.draft_sample_core(torch.from_numpy(dl),
                                       torch.Generator().manual_seed(0),
                                       **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=LAW_ATOL)
    # Every proposal lies in its row's support.
    assert (got.numpy()[np.arange(6), tok.numpy()] > 0).all()


@pytest.mark.parametrize("temperature,top_k,top_p",
                         [(1.0, None, None), (0.7, 8, 0.9)])
def test_spec_accept_emits_the_target_law(temperature, top_k, top_p):
    """The round's first emitted token (the draft when accepted, else
    the correction) follows the target's filtered law whatever the
    draft's law is."""
    V = 16
    rng = np.random.default_rng(11)
    tl_row = rng.normal(size=(1, 2, V)).astype(np.float32)
    dl_row = rng.normal(size=(1, V)).astype(np.float32)
    p = np.asarray(jax.nn.softmax(jgen.filter_logits(
        jnp.asarray(tl_row[:, 0]), temperature, top_k=top_k,
        top_p=top_p)), np.float64)[0]
    gen = torch.Generator().manual_seed(2)
    kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
    d0, q0 = tspec.draft_sample_core(
        torch.from_numpy(dl_row).expand(N_DRAWS, V), gen, **kw)
    a_b, corr = tspec.spec_accept_core(
        torch.from_numpy(tl_row).expand(N_DRAWS, 2, V), d0[:, None],
        q0[:, None], gen, torch.zeros(N_DRAWS, dtype=torch.int32),
        cap=1 << 20, **kw)
    first = torch.where(a_b >= 1, d0, corr[:, 0])
    tv, _ = _tv(first.numpy(), p, V)
    assert tv < TV_BOUND, tv
    assert 0 < float((a_b >= 1).float().mean()) < 1


def test_matching_draft_accepts_everything_like_jax():
    rng = np.random.default_rng(4)
    B, g, V = 3, 3, 12
    tl = rng.normal(size=(B, g + 1, V)).astype(np.float32)
    kw = dict(temperature=0.9, top_k=6)
    q = np.array(jax.nn.softmax(jgen.filter_logits(
        jnp.asarray(tl[:, :g]), 0.9, top_k=6)))
    drafts = q.argmax(-1)
    base = np.array([0, 10, 13], np.int32)          # the last: room 2
    ja, _ = jspec.spec_accept_core(
        jnp.asarray(tl), jnp.asarray(drafts, jnp.int32), jnp.asarray(q),
        jax.random.PRNGKey(1), jnp.asarray(base), cap=16, **kw)
    ta, tcorr = tspec.spec_accept_core(
        torch.from_numpy(tl), torch.from_numpy(drafts),
        torch.from_numpy(q), torch.Generator().manual_seed(1),
        torch.from_numpy(base), cap=16, **kw)
    assert ta.tolist() == np.asarray(ja).tolist() == [3, 3, 2]
    # The clamped row cut on an accepted draft: it emits that draft.
    assert tcorr[2, 0].item() == drafts[2, 2]
    # lockstep: every row cuts at the batch minimum, as in JAX.
    jl, _ = jspec.spec_accept_core(
        jnp.asarray(tl), jnp.asarray(drafts, jnp.int32), jnp.asarray(q),
        jax.random.PRNGKey(1), jnp.asarray(base), cap=16, lockstep=True,
        **kw)
    tl_, _ = tspec.spec_accept_core(
        torch.from_numpy(tl), torch.from_numpy(drafts),
        torch.from_numpy(q), torch.Generator().manual_seed(1),
        torch.from_numpy(base), cap=16, lockstep=True, **kw)
    assert tl_.tolist() == np.asarray(jl).tolist() == [2, 2, 2]
    greedy_j, _ = jspec.greedy_accept_core(
        jnp.asarray(tl), jnp.asarray(drafts, jnp.int32), jnp.asarray(base),
        cap=16, lockstep=True)
    greedy_t, _ = tspec.greedy_accept_core(
        torch.from_numpy(tl), torch.from_numpy(drafts),
        torch.from_numpy(base), cap=16, lockstep=True)
    assert greedy_t.tolist() == np.asarray(greedy_j).tolist()


def test_poisoned_verify_row_never_accepts_and_emits_minus_one():
    V = 8
    tl = torch.where(torch.arange(V) == 1, 50.0, -50.0).expand(1, 3, V)
    tl = tl.clone()
    tl[0, 1] = float("nan")
    qd = torch.softmax(torch.zeros(1, 2, V), -1)
    for seed in range(4):
        a_b, corr = tspec.spec_accept_core(
            tl, torch.tensor([[1, 1]]), qd,
            torch.Generator().manual_seed(seed),
            torch.zeros(1, dtype=torch.int32), cap=1 << 20,
            temperature=1.0)
        assert a_b.tolist() == [1] and corr.tolist() == [[-1]]
    tl[0, 0] = float("nan")                     # the cut row itself
    a_b, corr = tspec.spec_accept_core(
        tl, torch.tensor([[1, 1]]), qd, torch.Generator(),
        torch.zeros(1, dtype=torch.int32), cap=1 << 20, temperature=1.0)
    assert a_b.tolist() == [0] and corr.tolist() == [[-1]]


def _stochastic_server(seed=0):
    cfg = bridge.config_from_jax(jt.tiny(remat=False))
    from tpushare_torch.models import transformer as tt
    params = tt.init_params(0, cfg, device="cpu")
    params = dict(params, layers={k: v * 4.0 if v.ndim == 3 else v
                                  for k, v in params["layers"].items()})
    return tpaged.PagedSlotServer(
        params, cfg, n_slots=3, n_blocks=64, block_size=4, device="cpu",
        temperature=0.8, top_k=40, top_p=0.95, seed=seed, gamma=2,
        spec_horizon=2,
        speculative_draft=(tquant.quantize_params(params, cfg), cfg),
        draft_layers_hook=tquant.dequant_hook(cfg)), cfg


def test_stochastic_int8_self_round_one_fetch_and_reproducible():
    from tests.test_torch_paged import count_fetches

    def run(seed):
        srv, cfg = _stochastic_server(seed)
        srv.admit(np.arange(7))
        srv.admit(np.arange(20, 31))
        assert srv._spec_qdists is None
        counts, out, bufs = [], [], []
        with count_fetches(counts):
            for _ in range(4):
                counts.append(0)
                out.append(srv.step())
                bufs.append(srv._spec_qdists)
        assert counts == [1] * 4, counts
        assert srv.spec_rounds == 4 and srv.device_fetches == 2 + 4
        # The draft laws' buffer: allocated once for the round shape.
        assert all(b is bufs[0] for b in bufs)
        assert bufs[0].shape == (3, 4, cfg.vocab_size)
        toks = [t for o in out for v in o.values() for t in v]
        assert all(0 <= t < cfg.vocab_size for t in toks)
        assert 0 < srv.spec_accept_rate() <= 1
        return out

    assert run(0) == run(0)
