"""The port's serving slice (tpushare_torch.models.paged) against the JAX
package's PagedSlotServer, on the CPU in f32.

The same weights (bridged from a JAX init_params tree) and the same
prompts go through both servers: plain admits, ragged decode over more
than 12 ticks, an evict, prefix-hit admits (one of them a re-admit of
the evicted prompt) and a chunked admission. Greedy token streams must
be EQUAL. Logits of the admission prefill and of a decode step, and
the KV written, agree within 5e-5 abs + 5e-5 relative (f32; the
libraries sum in different orders, nothing else). Also: the one-fetch-per-
tick contract, the NaN -> -1 guard, pool bookkeeping and the options
that refuse until their ROADMAP item lands.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import paged as jpaged
from tpushare.models import serving as jserving
from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import paged as tpaged
from tpushare_torch.models import serving as tserving

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
    }


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


@pytest.fixture(scope="module", params=list(CONFIGS))
def both_logs(request):
    jcfg, jp, tcfg, tp = _pair(request.param)
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(n_slots=5, n_blocks=48, block_size=BS, prefix_cache=True)
    jsrv = jpaged.PagedSlotServer(jp, jcfg, **kw)
    tsrv = tpaged.PagedSlotServer(tp, tcfg, device="cpu", **kw)
    jlog = _scenario(jsrv, prompts, lambda p: jnp.asarray(p, jnp.int32))
    tlog = _scenario(tsrv, prompts, lambda p: p)
    return jlog, tlog, jsrv, tsrv


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
        with pytest.raises(NotImplementedError, match="ROADMAP A7"):
            tserving.TokenSampler(temperature=0.7)


class TestRefusals:
    @pytest.mark.parametrize("kw,item", [
        ({"speculative_draft": object()}, "A7"),
        ({"kv_quant": True}, "B1"),
        ({"multi_lora": object()}, "A9"),
        ({"mesh": object()}, "A10"),
        ({"kv_quota": object()}, "A5"),
        ({"forward_fn": object()}, "A8"),
        ({"host_tier": object()}, "A5"),
        ({"layers_hook": object()}, "A6"),
    ])
    def test_unported_options(self, kw, item):
        with pytest.raises(NotImplementedError, match=item):
            _small_server(**kw)

    def test_fused_tick_and_adapters_refuse(self):
        srv, _ = _small_server()
        slot = srv.admit_start(np.arange(6))
        with pytest.raises(NotImplementedError, match="A4"):
            srv.step(prefill_work=slot)
        with pytest.raises(NotImplementedError, match="A9"):
            srv.admit(np.arange(4), adapter=0)
