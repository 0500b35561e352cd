"""The port's serving slice (tpushare_torch.models.paged) against the JAX
package's PagedSlotServer, on the CPU in f32.

The same weights (bridged from a JAX init_params tree) and the same
prompts go through both servers: plain admits, ragged decode over more
than 12 ticks, an evict, prefix-hit admits (one of them a re-admit of
the evicted prompt) and a chunked admission; then fused admission ticks
(``step(prefill_work=slot)``: one with a prefix hit, one capped by a
tick budget and mixed with a serial chunk). That runs on plain pools,
on int8 (``kv_quant``) pools, and on int8-self speculative servers
(gamma 2, horizon 1 and 2). Greedy token streams must be EQUAL, and so
must the host table, lengths and the accepted-draft counts. Logits of
the admission prefill and of a decode step, and the KV written, agree
within 5e-5 abs + 5e-5 relative (f32; the libraries sum in different
orders, nothing else). Also: the one-fetch contract of plain ticks,
fused ticks and speculative rounds, the NaN -> -1 guard, pool
bookkeeping and the options that refuse until their ROADMAP item lands.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import paged as jpaged
from tpushare.models import quant as jquant
from tpushare.models import serving as jserving
from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import paged as tpaged
from tpushare_torch.models import quant as tquant
from tpushare_torch.models import serving as tserving
from tpushare_torch.models import spec as tspec

# x4 layer weights (see _pair) grow activations about fourfold over
# the init scale, and the summation-order error with them.
ATOL = 5e-5
BS = 4

CONFIGS = {
    "tiny": {},
    "gemma": {"norm_offset": 1.0, "embed_scale": True, "act": "gelu"},
    "llama": {"tie_embeddings": False, "rope_base": 5e5},
}


def _pair(name, seed=0):
    jcfg = jt.tiny(remat=False, **CONFIGS[name])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    # Scaled-up layer matrices: at the init scale a tiny model's greedy
    # stream just repeats one token, which would make stream equality
    # a weak check; x4 gives streams that change every tick.
    jp = dict(jp, layers={k: v * 4.0 if v.ndim == 3 else v
                          for k, v in jp["layers"].items()})
    return jcfg, jp, bridge.config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


def _prompts(vocab, seed=11):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, 8)
    return {
        "a": np.concatenate([prefix, rng.integers(0, vocab, 5)]),   # 13
        "b": rng.integers(0, vocab, 7),
        "c": np.concatenate([prefix, rng.integers(0, vocab, 3)]),   # hit 8
        "d": rng.integers(0, vocab, 10),
        # e: a's first 12 tokens (three full blocks) + 9 new;
        # f: 18 fresh tokens.
        "e": None,
        "f": rng.integers(0, vocab, 18),
    }


def _prompts_fused(vocab):
    p = _prompts(vocab)
    p["e"] = np.concatenate([p["a"][:12],
                             np.random.default_rng(12).integers(0, vocab, 9)])
    return p


def _scenario(srv, prompts, wrap):
    """Drive one server through the slice; returns its event log."""
    log = []

    def steps(n):
        for _ in range(n):
            log.append(("step", sorted(srv.step().items())))

    def admit(key):
        slot = srv.admit(wrap(prompts[key]))
        log.append(("admit", key, slot, srv.last_cached_len))

    admit("a")
    admit("b")
    steps(5)
    admit("c")                       # prefix hit on a's two full blocks
    steps(7)                         # ragged decode, >= 12 ticks so far
    srv.evict(0)
    log.append(("evict", 0))
    admit("a")                       # re-admit: a's blocks still cached
    steps(3)
    slot = srv.admit_start(wrap(prompts["d"]), chunk_tokens=4)
    while (tok := srv.admit_step(slot)) is None:
        pass
    log.append(("chunked", slot, tok))
    steps(2)
    return log


def _unaliased(srv):
    """Give the JAX server a fresh host ``active`` array before each of
    its calls. On the CPU backend ``jnp.asarray(self.active)`` can alias
    the numpy array without a copy, so a later in-place edit of
    ``active`` (a fused tick activating its admitted slot) reaches
    device work still queued under async dispatch: the same scenario
    then alternates between two answers over repeated runs (one with a
    length advanced by an extra 1). With the array replaced before
    every call, no queued work sees a later edit, and the answers are
    steady and equal to the port's."""
    for name in ("admit_start", "admit_step", "step", "evict"):
        def call(*a, _fn=getattr(srv, name), **kw):
            srv.active = srv.active.copy()
            return _fn(*a, **kw)
        setattr(srv, name, call)
    return srv


@pytest.fixture(scope="module", params=list(CONFIGS))
def both_logs(request):
    jcfg, jp, tcfg, tp = _pair(request.param)
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(n_slots=5, n_blocks=48, block_size=BS, prefix_cache=True)
    jsrv = _unaliased(jpaged.PagedSlotServer(jp, jcfg, **kw))
    tsrv = tpaged.PagedSlotServer(tp, tcfg, device="cpu", **kw)
    jlog = _scenario(jsrv, prompts, lambda p: jnp.asarray(p, jnp.int32))
    tlog = _scenario(tsrv, prompts, lambda p: p)
    return jlog, tlog, jsrv, tsrv


def _fused_scenario(srv, prompts, wrap):
    """The slice's scenario, then fused admission ticks beside the
    decode rows: a prefix-hit admission finished by one fused tick, and
    an admission that alternates a budget-capped fused tick, a serial
    chunk (which re-gathers the row the fused tick left stale) and
    fused ticks to its end."""
    log = _scenario(srv, prompts, wrap)

    def fused(slot, cap=None):
        while slot in srv._admissions:
            log.append(("fused", slot, sorted(srv.step(
                prefill_work=slot, max_chunk_tokens=cap).items())))

    srv.evict(1)
    log.append(("evict", 1))
    slot = srv.admit_start(wrap(prompts["e"]), chunk_tokens=8)
    log.append(("start", slot, srv.last_cached_len))
    fused(slot)
    for _ in range(2):
        log.append(("step", sorted(srv.step().items())))
    slot = srv.admit_start(wrap(prompts["f"]), chunk_tokens=8)
    log.append(("start", slot, srv.last_cached_len))
    log.append(("fused", slot, sorted(srv.step(
        prefill_work=slot, max_chunk_tokens=4).items())))
    log.append(("serial", slot, srv.admit_step(slot)))
    fused(slot)
    for _ in range(3):
        log.append(("step", sorted(srv.step().items())))
    return log


# (config, server options): plain pools, int8 pools, and int8-self
# speculative servers (the draft is the target's own int8 rounding,
# served through dequant_hook: ``--draft-preset int8-self``).
FUSED_CASES = {
    "fused-llama": ("llama", {}),
    "kvq-gemma": ("gemma", {"kv_quant": True}),
    "spec-h1-tiny": ("tiny", {"speculative": True, "gamma": 2}),
    "spec-h2-kvq-llama": ("llama", {"speculative": True, "gamma": 2,
                                    "spec_horizon": 2, "kv_quant": True}),
}


@pytest.fixture(scope="module", params=list(FUSED_CASES))
def fused_logs(request):
    name, opts = FUSED_CASES[request.param]
    jcfg, jp, tcfg, tp = _pair(name, seed=21)
    prompts = _prompts_fused(jcfg.vocab_size)
    kw = dict(n_slots=5, n_blocks=96, block_size=BS, prefix_cache=True)
    jkw, tkw = dict(opts), dict(opts)
    if jkw.pop("speculative", False):
        tkw.pop("speculative")
        jkw.update(speculative_draft=(jquant.quantize_params(jp, jcfg), jcfg),
                   draft_layers_hook=jquant.dequant_hook(jcfg))
        tkw.update(speculative_draft=(tquant.quantize_params(tp, tcfg), tcfg),
                   draft_layers_hook=tquant.dequant_hook(tcfg))
    jsrv = _unaliased(jpaged.PagedSlotServer(jp, jcfg, **kw, **jkw))
    tsrv = tpaged.PagedSlotServer(tp, tcfg, device="cpu", **kw, **tkw)
    jlog = _fused_scenario(jsrv, prompts,
                           lambda p: jnp.asarray(p, jnp.int32))
    tlog = _fused_scenario(tsrv, prompts, lambda p: p)
    return jlog, tlog, jsrv, tsrv


class TestFusedSpecKvqParity:
    def test_token_streams_equal(self, fused_logs):
        jlog, tlog, _, tsrv = fused_logs
        kinds = [e[0] for e in tlog]
        assert kinds.count("fused") >= 3 and "serial" in kinds
        assert ("start", 1, 12) in tlog          # the fused prefix hit
        assert tlog == jlog
        if tsrv.speculative:
            emitted = [len(t) for e in tlog if e[0] == "step"
                       for _, t in e[1]]
            assert max(emitted) > 1              # drafts were accepted

    def test_pool_state_and_counters_agree(self, fused_logs):
        _, _, jsrv, tsrv = fused_logs
        np.testing.assert_array_equal(tsrv.cache.host_table(),
                                      np.asarray(jsrv.cache.block_table))
        np.testing.assert_array_equal(tsrv.cache.host_lengths(),
                                      np.asarray(jsrv.cache.lengths))
        np.testing.assert_array_equal(tsrv.cache.lengths.numpy(),
                                      tsrv.cache.host_lengths())
        assert sorted(tsrv.cache.free) == sorted(jsrv.cache.free)
        assert tsrv.prefix_hit_tokens == jsrv.prefix_hit_tokens
        assert tsrv.device_fetches == jsrv.device_fetches
        if tsrv.speculative:
            assert tsrv.spec_rounds == jsrv.spec_rounds
            assert tsrv.spec_draft_tokens == jsrv.spec_draft_tokens
            assert tsrv.spec_accepted_tokens == jsrv.spec_accepted_tokens
            assert tsrv.spec_accept_rate() == jsrv.spec_accept_rate()
        kvq = tsrv.cache.pool_k_scale is not None
        assert kvq == (jsrv.cache.pool_k_scale is not None)
        if kvq:
            assert tsrv.cache.pool_k.dtype == torch.int8
            # Scale pages in the port's unpadded [L, nb, Hkv, bs] layout.
            assert tuple(tsrv.cache.pool_k_scale.shape) == (
                tsrv.cfg.n_layers, 96, tsrv.cfg.n_kv_heads, BS)


class TestSliceParity:
    def test_token_streams_equal(self, both_logs):
        jlog, tlog, _, _ = both_logs
        assert len([e for e in tlog if e[0] == "step"]) >= 17
        assert tlog == jlog

    def test_prefix_hits_and_pool_state_agree(self, both_logs):
        _, tlog, jsrv, tsrv = both_logs
        hits = [e[3] for e in tlog if e[0] == "admit"]
        assert hits == [0, 0, 8, 12]
        assert tsrv.prefix_hit_tokens == jsrv.prefix_hit_tokens
        np.testing.assert_array_equal(tsrv.cache.host_table(),
                                      np.asarray(jsrv.cache.block_table))
        np.testing.assert_array_equal(tsrv.cache.host_lengths(),
                                      np.asarray(jsrv.cache.lengths))
        np.testing.assert_array_equal(tsrv.cache.block_table.numpy(),
                                      tsrv.cache.host_table())
        np.testing.assert_array_equal(tsrv.cache.lengths.numpy(),
                                      tsrv.cache.host_lengths())
        assert sorted(tsrv.cache.free) == sorted(jsrv.cache.free)
        assert list(tsrv.cache.lru) == list(jsrv.cache.lru)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_logits(name):
    """Admission logits (whole and prefix-suffix) and one decode step's
    logits through the module-level functions of both packages."""
    jcfg, jp, tcfg, tp = _pair(name, seed=5)
    prompts = _prompts(jcfg.vocab_size, seed=6)
    jc = jpaged.init_paged_cache(jcfg, n_slots=2, n_blocks=24,
                                 block_size=BS)
    tc = tpaged.init_paged_cache(tcfg, n_slots=2, n_blocks=24,
                                 block_size=BS, device="cpu")
    jc = jpaged.admit(jc, 0, 13)
    tc = tpaged.admit(tc, 0, 13)
    jl, jc = jpaged.prefill_into(jp, jnp.asarray(prompts["a"]), jcfg, jc, 0)
    tl, tc = tpaged.prefill_into(tp, torch.from_numpy(prompts["a"]), tcfg,
                                 tc, 0)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    # Slot 1 reuses slot 0's first two blocks as a cached prefix.
    for c in (jc, tc):
        row = c.host_table()[0, :2].tolist() + [c.free.pop(), c.free.pop()]
        c.host_table()[1, :4] = row
    jc = jc.__class__(**{**jc.__dict__, "block_table": jnp.asarray(
        jc.host_table())})
    tc.block_table[1] = torch.from_numpy(tc.host_table()[1])
    jl, jc = jpaged.prefill_suffix_into(jp, jnp.asarray(prompts["c"]), jcfg,
                                        jc, 1, 8)
    tl, tc = tpaged.prefill_suffix_into(tp, torch.from_numpy(prompts["c"]),
                                        tcfg, tc, 1, 8)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=ATOL, rtol=ATOL)
    toks = np.array([[3], [7]])
    lengths = np.array([13, 11], np.int32)
    active = np.array([True, True])
    jout = jpaged.decode_core(
        jp, jnp.asarray(toks), jc.pool_k, jc.pool_v, jc.block_table,
        jnp.asarray(lengths), jnp.asarray(active), cfg=jcfg, block_size=BS)
    tout = tpaged.decode_core(
        tp, torch.from_numpy(toks), tc.pool_k, tc.pool_v, tc.block_table,
        torch.from_numpy(lengths), torch.from_numpy(active), cfg=tcfg)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]),
                               atol=ATOL, rtol=ATOL)
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[5]))


@contextlib.contextmanager
def count_fetches(counts):
    """Count every way a tensor's value reaches the host: .cpu(),
    .item(), .tolist(), .numpy() and the scalar conversions."""
    names = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
             "__float__", "__index__")
    orig = {n: getattr(torch.Tensor, n) for n in names}

    def spy(name):
        def wrapped(self, *a, **kw):
            counts[-1] += 1
            return orig[name](self, *a, **kw)
        return wrapped

    for n in names:
        setattr(torch.Tensor, n, spy(n))
    try:
        yield
    finally:
        for n in names:
            setattr(torch.Tensor, n, orig[n])


def _small_server(**kw):
    cfg = bridge.config_from_jax(jt.tiny(remat=False))
    from tpushare_torch.models import transformer as tt
    params = tt.init_params(0, cfg, device="cpu")
    return tpaged.PagedSlotServer(params, cfg, n_slots=3, n_blocks=32,
                                  block_size=BS, device="cpu", **kw), cfg


class TestTickContract:
    def test_one_fetch_per_tick(self):
        """Mirrors tests/test_sync_free.py: block growth, retirement and
        scheduling read host mirrors; the tick's ONE transfer is the
        token fetch in finalize()."""
        srv, cfg = _small_server(prefix_cache=True)
        rng = np.random.default_rng(1)
        srv.admit(rng.integers(0, cfg.vocab_size, 6))
        srv.admit(rng.integers(0, cfg.vocab_size, 3))
        srv.step()
        counts = []
        with count_fetches(counts):
            for _ in range(6):                  # crosses block bounds
                counts.append(0)
                assert srv.step()
        assert counts == [1] * 6, counts
        assert srv.device_fetches == 2 + 7

    @pytest.mark.parametrize("kv_quant", [False, True])
    def test_one_fetch_per_fused_tick_and_spec_round(self, kv_quant):
        """A speculative round moves drafts, correction and accepted
        counts in ONE transfer; a fused tick moves its decode tokens and
        a completing admission's first token in one."""
        params, cfg, qparams = _quantized_server()
        srv = tpaged.PagedSlotServer(
            params, cfg, n_slots=3, n_blocks=64, block_size=BS,
            device="cpu", kv_quant=kv_quant, gamma=2, spec_horizon=2,
            speculative_draft=(qparams, cfg),
            draft_layers_hook=tquant.dequant_hook(cfg))
        srv.admit(np.arange(7))
        slot = srv.admit_start(np.arange(30, 43), chunk_tokens=4)
        counts = []
        with count_fetches(counts):
            for _ in range(3):                  # speculative rounds
                counts.append(0)
                assert srv.step()
            while slot in srv._admissions:      # fused ticks
                counts.append(0)
                srv.step(prefill_work=slot)
        assert counts == [1] * len(counts) and len(counts) == 7, counts
        assert srv.active[slot] and srv.spec_rounds == 3

    def test_step_async_defers_the_fetch(self):
        srv, cfg = _small_server()
        srv.admit(np.arange(5))
        counts = [0]
        with count_fetches(counts):
            pending = srv.step_async()
            assert counts == [0]
            out = pending.finalize()
            assert counts == [1]
        assert list(out) == [0] and pending.slots == (0,)
        assert srv.step_async().finalize(invalid={0}) == {}

    def test_capacity_retires_slot(self):
        srv, cfg = _small_server(max_blocks_per_slot=2)
        slot = srv.admit(np.arange(5))          # 5 tokens, capacity 8
        got = [srv.step() for _ in range(4)]
        assert all(slot in g for g in got[:3])
        assert not srv.active[slot] and srv.step() == {}
        again = srv.admit(np.arange(3))         # releases the retired row
        assert again == slot
        assert srv.cache.live_blocks() == 1

    def test_pool_exhaustion_is_transient_and_leak_free(self):
        srv, cfg = _small_server(prefix_cache=True)
        free0 = len(srv.cache.free)
        slot = srv.admit(np.arange(60))
        with pytest.raises(tpaged.PoolExhausted):
            srv.admit(np.arange(100, 160))
        srv.evict(slot)
        assert srv.cache.live_blocks() == 0
        assert tpaged.reclaimable_blocks(srv.cache) == free0
        srv.admit(np.arange(100, 160))          # reclaims the LRU blocks


class TestSampler:
    def test_nan_row_picks_minus_one(self):
        logits = np.random.default_rng(2).normal(size=(3, 17)) \
            .astype(np.float32)
        logits[1, 4] = np.nan
        want = jserving.TokenSampler().pick(jnp.asarray(logits))
        got = tserving.TokenSampler().pick(torch.from_numpy(logits))
        assert got.tolist() == np.asarray(want).tolist()
        assert got.tolist()[1] == -1

    def test_temperature_refuses(self):
        """Temperature no longer refuses (sampling is ported): the
        sampler draws in-vocabulary tokens off its own seeded generator
        and never reads a global one."""
        logits = torch.randn(5, 17, generator=torch.Generator().manual_seed(0))
        picks = [tserving.TokenSampler(temperature=0.7, seed=3).pick(logits)
                 for _ in range(2)]
        assert picks[0].tolist() == picks[1].tolist()
        assert all(0 <= t < 17 for t in picks[0].tolist())


def _quantized_server(**kw):
    """A small server plus the int8-self draft of its own weights."""
    srv_cfg = bridge.config_from_jax(jt.tiny(remat=False))
    from tpushare_torch.models import transformer as tt
    params = tt.init_params(0, srv_cfg, device="cpu")
    params = dict(params, layers={k: v * 4.0 if v.ndim == 3 else v
                                  for k, v in params["layers"].items()})
    return params, srv_cfg, tquant.quantize_params(params, srv_cfg)


class TestPortedOptions:
    """The options that refused before speculative decoding, int8 KV
    and int8 weights were ported, each held to what it must keep."""

    def _serve(self, params, cfg, n_ticks=8, **kw):
        srv = tpaged.PagedSlotServer(params, cfg, n_slots=3, n_blocks=64,
                                     block_size=BS, device="cpu", **kw)
        rng = np.random.default_rng(4)
        for n in (9, 5):
            srv.admit(rng.integers(0, cfg.vocab_size, n))
        out = {0: [], 1: []}
        while min(len(v) for v in out.values()) < n_ticks:
            for s, t in srv.step().items():
                out[s] += t if isinstance(t, list) else [t]
        return {s: v[:n_ticks] for s, v in out.items()}, srv

    @pytest.mark.parametrize("option", ["speculative_draft", "kv_quant",
                                        "layers_hook"])
    def test_option_serves(self, option):
        params, cfg, qparams = _quantized_server()
        hook = tquant.dequant_hook(cfg)
        if option == "speculative_draft":
            # Greedy speculation changes speed, never the stream.
            want, _ = self._serve(params, cfg)
            got, srv = self._serve(params, cfg, gamma=3,
                                   speculative_draft=(qparams, cfg),
                                   draft_layers_hook=hook)
            assert got == want and srv.spec_rounds > 0
            assert srv.spec_accepted_tokens > 0
        elif option == "kv_quant":
            # The kernels' plain versions (f32 dequant) against the
            # reference's gathered view over the same int8 pools.
            want, _ = self._serve(params, cfg, kv_quant=True,
                                  attn_impl="reference")
            got, srv = self._serve(params, cfg, kv_quant=True)
            assert got == want
            assert srv.cache.pool_k.dtype == torch.int8
            assert srv.cache.pool_k_scale.dtype == torch.float32
        else:
            # int8 weights through the hook serve what the same weights
            # widened once up front serve.
            wide = dict(qparams, layers={
                k: torch.stack([hook({n: qparams["layers"][n][li]
                                      for n in qparams["layers"]})[k]
                                for li in range(cfg.n_layers)])
                for k in params["layers"]})
            want, _ = self._serve(wide, cfg)
            got, _ = self._serve(qparams, cfg, layers_hook=hook)
            assert got == want

    def test_fused_tick_serves_beside_decode(self):
        """A fused tick carries the admission's chunk beside the decode
        rows; the completing tick returns its first token too."""
        params, cfg, _ = _quantized_server()
        srv = tpaged.PagedSlotServer(params, cfg, n_slots=3, n_blocks=64,
                                     block_size=BS, device="cpu")
        srv.admit(np.arange(5))
        slot = srv.admit_start(np.arange(10, 21), chunk_tokens=4)
        outs = []
        while slot in srv._admissions:
            outs.append(srv.step(prefill_work=slot))
        assert len(outs) == 3
        assert all(list(o) == [0] for o in outs[:-1])
        assert sorted(outs[-1]) == [0, slot] and srv.active[slot]
        assert srv.cache.host_lengths()[slot] == 11
        assert srv.cache.host_lengths()[0] == 5 + 3


class TestRefusals:
    @pytest.mark.parametrize("kw,item", [
        ({"mesh": object()}, "A10"),
    ])
    def test_unported_options(self, kw, item):
        """A mesh is ported (ROADMAP ``item``, A10a; its parity:
        tests/test_torch_sharded_serving.py): it must be a bound
        ServingMesh."""
        assert item == "A10"
        with pytest.raises(TypeError, match="ServingMesh"):
            _small_server(**kw)

    def test_stochastic_speculation_refuses(self):
        """Stochastic speculation no longer refuses (ported): the cores
        run and a temperature > 0 int8-self server serves rounds whose
        tokens stay in the vocabulary."""
        params, cfg, qparams = _quantized_server()
        srv = tpaged.PagedSlotServer(params, cfg, n_slots=2, n_blocks=8,
                                     device="cpu", temperature=0.5,
                                     speculative_draft=(qparams, cfg),
                                     draft_layers_hook=tquant.dequant_hook(
                                         cfg))
        slot = srv.admit(np.arange(5))
        toks = srv.step()[slot]
        assert 1 <= len(toks) <= srv.gamma + 1
        assert all(0 <= t < cfg.vocab_size for t in toks)
        tok, q = tspec.draft_sample_core(torch.zeros(1, 6),
                                         torch.Generator(),
                                         temperature=1.0)
        assert 0 <= int(tok) < 6 and torch.allclose(q, torch.full_like(
            q, 1 / 6))

    def test_adapters_refuse(self):
        """Without a bank only adapter -1 passes: another index, or a
        bool, is the reference's ValueError, before any slot is taken."""
        srv, _ = _small_server()
        for bad, words in ((0, "out of range"), (True, "must be an int")):
            with pytest.raises(ValueError, match=words):
                srv.admit(np.arange(4), adapter=bad)
        assert not srv.active.any() and not srv._admissions
