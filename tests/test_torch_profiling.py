"""The port's measurement layer (tpushare_torch/utils/profiling.py and its
callers) against the JAX package's, on the CPU.

- ``transformer_flops`` equals the JAX count exactly on bridged configs
  (tiny, Gemma-2B, Gemma-2-2B, Llama-3-8B), forward and training.
- ``mfu``, ``bandwidth_utilization`` and ``phase_roofline`` equal the
  JAX functions on the same inputs once both peak tables hold one
  shared test key; an unknown key, ``on_chip=False`` and the CPU (no
  card, so no key) give None. ``card_key`` maps exact card names only.
- ``quant.param_bytes`` and ``moe.decode_phase_bytes`` equal the JAX
  byte counts on bridged ``moe.tiny`` int8 trees (f32 and bf16 KV
  widths), and the phases a paged MoE decode tick marks are exactly
  ``decode_phase_bytes``' keys.
- ``paged.paged_decode_step``: the same lengths (device and host
  mirror) and logits within ATOL of JAX's ``paged_decode_step`` over
  bridged weights, with a masked and an all-active step, on plain and
  int8 pools; the masked slot's blocks stay as they were.
- ``time_step`` / ``time_step_chained`` / ``trace`` on the CPU, and
  ``trainer.fit``'s MFU line (none on the CPU, one against a patched
  peak key).
"""

import dataclasses
import functools
import json
import logging
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpushare.models import moe as jm
from tpushare.models import paged as jpaged
from tpushare.models import quant as jq
from tpushare.models import transformer as jt
from tpushare.utils import profiling as jprof

from tpushare_torch.models import bridge
from tpushare_torch.models import moe as tm
from tpushare_torch.models import paged as tpaged
from tpushare_torch.models import quant as tq
from tpushare_torch.models import trainer
from tpushare_torch.models import training as ttr
from tpushare_torch.models import transformer as tt
from tpushare_torch.utils import profiling as tprof

#: f32 on both sides; the libraries sum in different orders (the same
#: limit as tests/test_torch_paged.py, whose x4 weights these share).
ATOL = 5e-5
BS = 4
KEY = "test-card"


@pytest.fixture
def shared_key(monkeypatch):
    """Both packages' peak tables given one made-up card."""
    for mod in (jprof, tprof):
        monkeypatch.setitem(mod.PEAK_FLOPS, KEY, 123e12)
        monkeypatch.setitem(mod.HBM_BANDWIDTH, KEY, 2.5e12)


# ---------------------------------------------------------------------------
# FLOPs, shares, peak keys
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("training", [False, True], ids=["fwd", "train"])
@pytest.mark.parametrize("name", ["tiny", "gemma_2b", "gemma2_2b",
                                  "llama3_8b"])
def test_transformer_flops_equal(name, training):
    jcfg = getattr(jt, name)()
    tcfg = bridge.config_from_jax(jcfg)
    for batch, seq in ((1, 8192), (4, 1024), (3, 17)):
        want = jprof.transformer_flops(jcfg, batch, seq, training=training)
        got = tprof.transformer_flops(tcfg, batch, seq, training=training)
        assert got == want


def test_gemma2_2b_step_count():
    """slice_train's step on the card: Gemma-2-2B, 1 x 8192, training."""
    got = tprof.transformer_flops(tt.gemma2_2b(), 1, 8192, training=True)
    assert got == pytest.approx(1.50e14, rel=0.01)


def _snapshot():
    timer = jprof.PhaseTimer()
    timer.seconds = {"embed": 0.001, "attn": 0.02, "expert_gemm": 0.05,
                     "dispatch": 0.004, "unembed": 0.003}
    timer.counts = dict.fromkeys(timer.seconds, 4)
    return timer.snapshot()


def test_shares_equal_on_a_shared_key(shared_key):
    for flops, sec, n in ((1.5e14, 1.0797, 1), (3e12, 0.02, 4),
                          (1e9, 0.0, 1)):
        assert tprof.mfu(flops, sec, KEY, n) == jprof.mfu(flops, sec, KEY, n)
    for nbytes, sec, n in ((5.1e9, 0.0036, 1), (1e6, 1e-5, 2),
                           (1e6, -1.0, 1)):
        assert tprof.bandwidth_utilization(nbytes, sec, KEY, n) == \
            jprof.bandwidth_utilization(nbytes, sec, KEY, n)
    snap = _snapshot()
    nbytes = {"embed": 0, "attn": 3 << 30, "expert_gemm": 40 << 30,
              "unembed": 500 << 20}
    for steps in (1, 4):
        want = jprof.phase_roofline(snap, nbytes, steps, KEY)
        got = tprof.phase_roofline(snap, nbytes, steps, KEY)
        assert got == want
        assert got["expert_gemm"]["pct_of_roofline"] is not None
        assert got["dispatch"]["pct_of_roofline"] is None    # no bytes
    assert tprof.phase_roofline(snap, nbytes, 4, KEY, on_chip=False) == \
        jprof.phase_roofline(snap, nbytes, 4, KEY, on_chip=False)


def test_no_share_without_a_known_card(shared_key):
    snap = _snapshot()
    nbytes = {"attn": 1 << 30, "expert_gemm": 2 << 30}
    for key in ("h100-pcie", "v5e"):
        assert tprof.mfu(1e12, 1.0, key) is None
        assert tprof.bandwidth_utilization(1e9, 1.0, key) is None
        assert all(r["pct_of_roofline"] is None for r in
                   tprof.phase_roofline(snap, nbytes, 1, key).values())
    # No key given: the current card's, and the CPU has none.
    assert tprof.card_key() is None
    assert tprof.mfu(1e12, 1.0) is None
    assert tprof.bandwidth_utilization(1e9, 1.0) is None
    rows = tprof.phase_roofline(snap, nbytes, 1)
    assert all(r["pct_of_roofline"] is None for r in rows.values())
    assert rows["expert_gemm"]["fraction"] == snap["expert_gemm"]["fraction"]
    for key in tprof.PEAK_FLOPS:
        assert not key.startswith("v"), "no TPU peak in the port"


def test_peaks_are_the_h100_sxm_data_sheet():
    assert tprof.PEAK_FLOPS["h100-sxm"] == 989e12
    assert tprof.HBM_BANDWIDTH["h100-sxm"] == 3.35e12
    assert set(tprof.CARD_KEYS.values()) <= set(tprof.PEAK_FLOPS)
    assert set(tprof.PEAK_FLOPS) == set(tprof.HBM_BANDWIDTH)


@pytest.mark.parametrize("name,key", [
    ("NVIDIA H100 80GB HBM3", "h100-sxm"), ("NVIDIA H100 PCIe", None),
    ("NVIDIA H100 NVL", None), ("NVIDIA A100-SXM4-80GB", None)])
def test_card_key_maps_exact_names(monkeypatch, name, key):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: name)
    for dev in (None, 0, "cuda", torch.device("cuda", 0)):
        assert tprof.card_key(dev) == key
    assert tprof.card_key("cpu") is None


# ---------------------------------------------------------------------------
# Byte floors: param_bytes, decode_phase_bytes, the phases they key
# ---------------------------------------------------------------------------

def _moe_int8(dtype=jnp.float32):
    jcfg = dataclasses.replace(jm.tiny(remat=False), dtype=dtype)
    jp = jm.init_params(jax.random.PRNGKey(3), jcfg)
    jqp = jq.quantize_params(jp, jcfg)
    return jcfg, jqp, bridge.moe_config_from_jax(jcfg), \
        bridge.params_from_jax(jqp, device="cpu")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_param_and_phase_bytes_equal(dtype):
    """No leaf differs by design: the bridge keeps every leaf's dtype and
    shape (int8 ``#q8`` leaves, f32 ``#scale`` leaves [L, E, 1, Out],
    the model-dtype norms, router and embeddings)."""
    jcfg, jqp, tcfg, tqp = _moe_int8(dtype)
    assert tq.param_bytes(tqp) == jq.param_bytes(jqp)
    for kv_tokens in (0, 37, 4096):
        assert tm.decode_phase_bytes(tcfg, tqp, kv_tokens) == \
            jm.decode_phase_bytes(jcfg, jqp, kv_tokens)
    dense = jt.init_params(jax.random.PRNGKey(4), jt.tiny())
    assert tq.param_bytes(bridge.params_from_jax(dense, device="cpu")) == \
        jq.param_bytes(dense)
    assert tq.param_bytes({"a": [torch.zeros(3, dtype=torch.int8), None],
                           "b": (torch.zeros(2, 2),)}) == 3 + 16


def test_phase_bytes_key_the_phases_a_decode_tick_marks():
    """A paged MoE server over int8 experts (``fused_expert_hook``) with
    a PhaseTimer on its forward, as chip_smoke's slice_moe window runs
    it: the tick marks exactly ``decode_phase_bytes``' phases, the
    fractions sum to 1, and off the card every pct is None."""
    _, _, tcfg, tqp = _moe_int8()
    pt = tprof.PhaseTimer()
    srv = tpaged.PagedSlotServer(
        tqp, tcfg, n_slots=2, n_blocks=16, block_size=BS,
        max_blocks_per_slot=8, layers_hook=tq.fused_expert_hook(tcfg),
        forward_fn=functools.partial(tm.paged_forward, phase_timer=pt),
        device="cpu")
    rng = np.random.default_rng(5)
    for n in (9, 5):
        srv.admit(rng.integers(0, tcfg.vocab_size, n))
    assert pt.snapshot() == {}          # not started: admissions mark nothing
    for _ in range(2):
        pt.start()
        srv.step()
    snap = pt.snapshot()
    nbytes = tm.decode_phase_bytes(tcfg, tqp, 16)
    assert set(snap) == set(nbytes)
    assert sum(r["fraction"] for r in snap.values()) == \
        pytest.approx(1.0, abs=0.01)
    rows = tprof.phase_roofline(snap, nbytes, 2)
    assert set(rows) == set(nbytes)
    assert all(r["pct_of_roofline"] is None for r in rows.values())
    assert rows["expert_gemm"]["bytes_per_step_mib"] > 0


# ---------------------------------------------------------------------------
# paged_decode_step against JAX's
# ---------------------------------------------------------------------------

def _dense_pair(seed=0):
    jcfg = jt.tiny(remat=False)
    jp = jt.init_params(jax.random.PRNGKey(seed), jcfg)
    jp = dict(jp, layers={k: v * 4.0 if v.ndim == 3 else v
                          for k, v in jp["layers"].items()})
    return jcfg, jp, bridge.config_from_jax(jcfg), \
        bridge.params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf", "int8"])
def test_paged_decode_step_matches_jax(kv_quant):
    jcfg, jp, tcfg, tp = _dense_pair(seed=7)
    jc = jpaged.init_paged_cache(jcfg, n_slots=3, n_blocks=24,
                                 block_size=BS, kv_quant=kv_quant)
    tc = tpaged.init_paged_cache(tcfg, n_slots=3, n_blocks=24,
                                 block_size=BS, kv_quant=kv_quant,
                                 device="cpu")
    rng = np.random.default_rng(8)
    for slot, n in enumerate((13, 7, 10)):
        p = rng.integers(0, jcfg.vocab_size, n)
        jc = jpaged.admit(jc, slot, n)
        tc = tpaged.admit(tc, slot, n)
        _, jc = jpaged.prefill_into(jp, jnp.asarray(p), jcfg, jc, slot)
        _, tc = tpaged.prefill_into(tp, torch.from_numpy(p), tcfg, tc, slot)
    toks = rng.integers(0, jcfg.vocab_size, (3, 1))
    masked = np.array([True, False, True])
    idle = [b for b in tc.host_table()[1] if b >= 0]
    before = tc.pool_k[:, idle].clone()
    for active in (masked, None):
        jl, jc = jpaged.paged_decode_step(
            jp, jnp.asarray(toks), jcfg, jc,
            active=None if active is None else jnp.asarray(active))
        tl, tc2 = tpaged.paged_decode_step(
            tp, torch.from_numpy(toks), tcfg, tc,
            active=None if active is None else torch.from_numpy(active))
        assert tc2 is tc                        # updated in place
        rows = np.nonzero(masked if active is not None else [1, 1, 1])[0]
        np.testing.assert_allclose(tl.numpy()[rows], np.asarray(jl)[rows],
                                   atol=ATOL, rtol=ATOL)
        np.testing.assert_array_equal(tc.lengths.numpy(),
                                      np.asarray(jc.lengths))
        np.testing.assert_array_equal(tc.host_lengths(), jc.host_lengths())
        if active is not None:
            # The masked slot wrote only to the trash block.
            assert torch.equal(tc.pool_k[:, idle], before)
        toks = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None]
    np.testing.assert_array_equal(tc.host_lengths(), [15, 8, 12])


def test_paged_decode_step_takes_a_host_mask():
    """A numpy mask is uploaded; the result equals the tensor mask's."""
    _, _, tcfg, tp = _dense_pair(seed=9)
    out = []
    for mask in (np.array([False, True]), torch.tensor([False, True])):
        c = tpaged.init_paged_cache(tcfg, n_slots=2, n_blocks=8,
                                    block_size=BS, device="cpu")
        for slot in range(2):
            c = tpaged.admit(c, slot, 5)
            _, c = tpaged.prefill_into(tp, torch.arange(5), tcfg, c, slot)
        logits, c = tpaged.paged_decode_step(
            tp, torch.tensor([[1], [2]]), tcfg, c, active=mask)
        out.append((logits[1], c.host_lengths().tolist()))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1] == out[1][1] == [5, 6]


# ---------------------------------------------------------------------------
# Timers and the trace on the CPU
# ---------------------------------------------------------------------------

def test_time_step_positive_median():
    x = torch.randn(64, 64)
    calls = []

    def fn(a, scale=1.0):
        calls.append(1)
        return a @ a * scale

    assert tprof.time_step(fn, x, warmup=1, iters=3, scale=2.0) > 0
    assert len(calls) == 4


def test_time_step_chained_passes_consts_and_flags_jitter():
    """consts reach every body call as arguments (the same objects); a
    body far below the jitter floor reads not credible."""
    w = torch.eye(8)
    seen = set()

    def body(c, m):
        seen.add(id(m))
        return c @ m + 1.0

    sec, credible = tprof.time_step_chained(body, torch.zeros(8, 8), w,
                                            k_lo=2, k_hi=6, iters=3)
    assert seen == {id(w)}
    assert sec > 0 and credible is False


def test_time_step_chained_reads_a_slow_body():
    """A body that sleeps 2 ms a step (its carry a dict: the scalar read
    takes the first tensor): the chained per-step time holds the sleep
    and is credible above a 5 ms floor."""
    def body(c):
        time.sleep(2e-3)
        return {"carry": c["carry"] + 1}

    sec, credible = tprof.time_step_chained(
        body, {"carry": torch.zeros(2)}, k_lo=2, k_hi=12, iters=3,
        min_credible_delta_s=0.005)
    assert credible and 1e-3 <= sec < 0.1


def test_trace_exports_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path / "tr")) as path:
        torch.randn(32, 32) @ torch.randn(32, 32)
    with open(path, encoding="utf-8") as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    errors = []

    def other():
        try:
            with tprof.trace(str(tmp_path / "tr2")):
                pass
        except RuntimeError as e:
            errors.append(str(e))

    t = threading.Thread(target=other)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and errors and "main thread" in errors[0]


# ---------------------------------------------------------------------------
# trainer.fit's MFU line
# ---------------------------------------------------------------------------

def _fit_lines(caplog, **kw):
    cfg = tt.tiny()
    params = tt.init_params(0, cfg, device="cpu")
    tok = torch.zeros((1, 9), dtype=torch.int64)
    step = functools.partial(ttr.adamw_train_step, cfg=cfg)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="tpushare_torch.trainer"):
        trainer.fit(step, params, ttr.adamw_init(params), [tok] * 4,
                    steps=4, log_every=2, tokens_per_step=8, **kw)
    return [r.getMessage() for r in caplog.records
            if r.name == "tpushare_torch.trainer"]


def test_fit_logs_mfu_only_against_a_known_peak(caplog, shared_key,
                                                monkeypatch):
    """No mfu on the CPU; against the card's key the second window's
    line carries it, over the world size's peaks. fit's clock is a
    counter that ticks 1 s a read, so its second window spans 1 s over
    2 steps: mfu = flops_per_step / 0.5 s / (peak x world size)."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(trainer, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks))))
    flops = 1e13
    cpu = _fit_lines(caplog, flops_per_step=flops)
    assert len(cpu) == 2 and all("mfu" not in m for m in cpu)
    assert cpu[1].endswith("| 16 tok/s")
    monkeypatch.setattr(tprof, "card_key", lambda device=None: KEY)
    for n in (1, 4):
        monkeypatch.setattr(trainer, "_world_size", lambda n=n: n)
        lines = _fit_lines(caplog, flops_per_step=flops)
        assert "mfu" not in lines[0]
        want = 100 * flops / 0.5 / (123e12 * n)
        assert lines[1].endswith(f"| mfu {want:.1f}%"), lines[1]
