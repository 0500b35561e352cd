"""The port's dense-row slot server (tpushare_torch.models.serving.
SlotServer) against the JAX package's SlotServer, on the CPU in f32.

The same weights (bridged from a JAX init_params tree, layer matrices
x4 so greedy streams change every tick) and the same prompts go through
both servers: whole admissions, ragged decode ticks (the S = 1 branch:
``flash_decode``'s plain version on the CPU), an evict and re-admit, a
serial chunked admission (``admit_start`` / ``admit_step``), and fused
ticks (``step(prefill_work=slot)``, one capped by a tick budget and
mixed with a serial chunk). That runs on the tiny config and on a
Gemma-2-style one (window, alternation, softcaps, post-norms), with
whole admissions in ``prefill_chunk`` pieces, and over int8 rows
(``kv_quant``). Greedy token streams must be EQUAL, and so must the
lengths and fetch counts. Also: one device-to-host fetch per tick and
per fused tick, and the options that refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import serving as jserving
from tpushare.models import transformer as jt

from tpushare_torch.models import bridge
from tpushare_torch.models import serving as tserving
from tests.test_torch_paged import _unaliased, count_fetches

CONFIGS = {
    "tiny": {},
    "gemma2": {"norm_offset": 1.0, "embed_scale": True, "act": "gelu",
               "sliding_window": 6, "alternate_sliding": True,
               "attn_softcap": 20.0, "final_softcap": 15.0,
               "post_norms": True},
}

# (config, server options)
CASES = {
    "tiny": ("tiny", {}),
    "gemma2": ("gemma2", {}),
    "tiny-prefill-chunk": ("tiny", {"prefill_chunk": 4}),
    "gemma2-kv-quant": ("gemma2", {"kv_quant": True}),
}


def _pair(name, seed=0):
    jcfg = jt.tiny(remat=False, **CONFIGS[name])
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, layers={k: v * 4.0 if v.ndim == 3 else v
                          for k, v in jp["layers"].items()})
    return jcfg, jp, bridge.config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


def _prompts(vocab):
    rng = np.random.default_rng(31)
    return {n: rng.integers(0, vocab, s) for n, s in
            (("a", 13), ("b", 6), ("c", 9), ("d", 11), ("e", 10),
             ("f", 7))}


def _scenario(srv, prompts, wrap):
    log = []

    def steps(n):
        for _ in range(n):
            log.append(("step", sorted(srv.step().items())))

    def fused(slot, cap=None):
        while slot in srv._admissions:
            log.append(("fused", slot, sorted(srv.step(
                prefill_work=slot, max_chunk_tokens=cap).items())))

    for key in ("a", "b"):
        log.append(("admit", key, srv.admit(wrap(prompts[key]))))
    steps(4)
    srv.evict(0)
    log.append(("admit", "c", srv.admit(wrap(prompts["c"]))))
    steps(3)
    slot = srv.admit_start(wrap(prompts["d"]), chunk_tokens=4)
    while (tok := srv.admit_step(slot)) is None:
        log.append(("step", sorted(srv.step().items())))
    log.append(("chunked", slot, tok))
    steps(2)
    slot = srv.admit_start(wrap(prompts["e"]), chunk_tokens=4)
    log.append(("fused", slot, sorted(srv.step(
        prefill_work=slot, max_chunk_tokens=2).items())))
    log.append(("serial", slot, srv.admit_step(slot)))
    fused(slot)
    srv.evict(1)
    slot = srv.admit_start(wrap(prompts["f"]), chunk_tokens=4)
    fused(slot)
    steps(3)
    return log


@pytest.fixture(scope="module", params=list(CASES))
def logs(request):
    name, opts = CASES[request.param]
    jcfg, jp, tcfg, tp = _pair(name)
    prompts = _prompts(jcfg.vocab_size)
    kw = dict(n_slots=4, max_len=40, **opts)
    jsrv = _unaliased(jserving.SlotServer(jp, jcfg, **kw))
    tsrv = tserving.SlotServer(tp, tcfg, device="cpu", **kw)
    jlog = _scenario(jsrv, prompts, lambda p: jnp.asarray(p, jnp.int32))
    tlog = _scenario(tsrv, prompts, lambda p: p)
    return jlog, tlog, jsrv, tsrv


class TestSlotServerParity:
    def test_token_streams_equal(self, logs):
        jlog, tlog, _, _ = logs
        kinds = [e[0] for e in tlog]
        assert kinds.count("fused") >= 4 and "serial" in kinds
        assert kinds.count("step") >= 12
        assert tlog == jlog

    def test_lengths_and_fetches_agree(self, logs):
        _, _, jsrv, tsrv = logs
        np.testing.assert_array_equal(tsrv._lengths_np,
                                      np.asarray(jsrv.lengths))
        np.testing.assert_array_equal(tsrv.lengths.numpy(),
                                      tsrv._lengths_np)
        np.testing.assert_array_equal(tsrv.active, jsrv.active)
        assert tsrv.device_fetches == jsrv.device_fetches
        kvq = "k_scale" in tsrv.cache
        assert kvq == ("k_scale" in jsrv.cache)
        if kvq:
            assert tsrv.cache["k"].dtype == torch.int8


def test_admission_logits_match_jax():
    """The first admission's logits row and the first tick's, through
    both servers' samplers."""
    jcfg, jp, tcfg, tp = _pair("gemma2", seed=3)
    prompts = _prompts(jcfg.vocab_size)
    seen = {}
    for tag, srv, wrap in (
            ("j", jserving.SlotServer(jp, jcfg, n_slots=2, max_len=32),
             lambda p: jnp.asarray(p, jnp.int32)),
            ("t", tserving.SlotServer(tp, tcfg, n_slots=2, max_len=32,
                                      device="cpu"), lambda p: p)):
        rows = []
        pick = srv._sampler.pick
        srv._sampler.pick = lambda lg, _p=pick: (
            rows.append(np.asarray(lg, np.float32)), _p(lg))[1]
        srv.admit(wrap(prompts["a"]))
        srv.admit(wrap(prompts["b"]))
        srv.step()
        seen[tag] = rows
    assert len(seen["j"]) == len(seen["t"]) == 3
    for a, b in zip(seen["t"], seen["j"]):
        np.testing.assert_allclose(a, b, atol=5e-5 * np.abs(b).max(), rtol=0)


class TestTickContract:
    def test_one_fetch_per_tick_and_fused_tick(self):
        jcfg, jp, tcfg, tp = _pair("tiny", seed=4)
        srv = tserving.SlotServer(tp, tcfg, n_slots=3, max_len=40,
                                  device="cpu")
        srv.admit(np.arange(6))
        srv.admit(np.arange(10, 13))
        slot = srv.admit_start(np.arange(20, 31), chunk_tokens=4)
        counts = []
        with count_fetches(counts):
            for _ in range(3):
                counts.append(0)
                assert srv.step()
            while slot in srv._admissions:
                counts.append(0)
                srv.step(prefill_work=slot)
        assert counts == [1] * 6, counts
        assert srv.active[slot]

    def test_step_async_defers_the_fetch(self):
        _, _, tcfg, tp = _pair("tiny", seed=5)
        srv = tserving.SlotServer(tp, tcfg, n_slots=2, max_len=16,
                                  device="cpu")
        srv.admit(np.arange(5))
        counts = [0]
        with count_fetches(counts):
            pending = srv.step_async()
            assert counts == [0]
            pending.finalize()
            assert counts == [1]

    def test_capacity_retires_slot(self):
        _, _, tcfg, tp = _pair("tiny", seed=6)
        srv = tserving.SlotServer(tp, tcfg, n_slots=2, max_len=8,
                                  device="cpu")
        slot = srv.admit(np.arange(5))
        got = [srv.step() for _ in range(4)]
        assert all(slot in g for g in got[:3])
        assert not srv.active[slot] and srv.step() == {}


class TestRefusals:
    @pytest.mark.parametrize("kw,item", [({"mesh": object()}, "A10")])
    def test_unported_options(self, kw, item):
        """A mesh is ported (ROADMAP ``item``, A10a; its parity:
        tests/test_torch_sharded_serving.py): it must be a bound
        ServingMesh."""
        assert item == "A10"
        _, _, tcfg, tp = _pair("tiny")
        with pytest.raises(TypeError, match="ServingMesh"):
            tserving.SlotServer(tp, tcfg, n_slots=2, max_len=8,
                                device="cpu", **kw)

    def test_no_free_slot_and_long_prompt(self):
        from tpushare_torch.models.paged import PoolExhausted
        _, _, tcfg, tp = _pair("tiny")
        srv = tserving.SlotServer(tp, tcfg, n_slots=1, max_len=8,
                                  device="cpu")
        with pytest.raises(ValueError, match="max_len"):
            srv.admit(np.arange(8))
        srv.admit(np.arange(3))
        with pytest.raises(PoolExhausted):
            srv.admit(np.arange(3))
        with pytest.raises(ValueError, match="out of range"):
            srv.admit_start(np.arange(3), adapter=0)
