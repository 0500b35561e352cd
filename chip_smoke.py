#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port
(tpushare_torch) still starts and serves on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each, each with its own seconds:

  env     torch/CUDA versions, the card's name and power limit.
  build   compiles every kernel of the main paths from tpushare_torch/csrc
          (one nvcc per source, started together) and times it.
  kernels each kernel against its plain PyTorch version on the card, at
          the shapes the two slices below launch: prefill at every
          admission shape (derived from the admission's padding rule,
          paged.admission_len) of both slices; decode, bf16 and int8
          pages, at the slices' positions; verify, bf16 and int8 pages,
          at the Llama slice's speculative round (Sq 5) and fused ticks
          (Sq = each chunk width), at Gemma-2B's GQA 8 / head_dim 256,
          and with a Gemma-2 window + softcap. Each case reports the
          kernel's time, the plain version's, the least time the card
          could take (bound) and a library route's (SDPA for prefill;
          for the paged kernels: gather the live pages into a dense
          view, dequantize int8, then SDPA with the boolean mask,
          timed together). Planted faults must fail the same check: an
          off-by-one causal edge (prefill, verify), a dropped page
          (decode), two heads' scale pages swapped (int8).
  slice   Gemma-2B at full width (random bf16 weights from a seeded
          generator) served by PagedSlotServer over the paged KV pool:
          8 prompts of 16..2048 tokens, 32 greedy decode ticks (then 4
          more under torch.profiler, CUDA activity only: device time by
          kernel and the card's idle share in that window), evict, then
          a second wave whose prompts hit the prefix cache, 8 ticks. A
          short untimed pass of the same workload on the plain path
          warms cuBLAS and the allocator first. A second server on the
          same weights with attn_impl="reference" checks the logits of
          every admission (both waves) and of each wave's first tick.
  slice_llama
          Llama-3-8B at full width (random bf16 weights, no cut in depth
          or width) through two servers, each against an
          attn_impl="reference" twin on the same weights: (a) int8-self
          speculative decoding (the draft is quant.quantize_params of
          the target, served through quant.dequant_hook; gamma 4) over
          bf16 pools, (b) int8 KV pools (kv_quant). Both admit 4
          prompts of 100..2048 tokens whole, then 4 of 700..3000 tokens
          in 512-token chunks, each chunk a fused tick
          (step(prefill_work=slot)) beside the decode rows; then (a)
          runs 16 speculative rounds, (b) 16 decode ticks. Logits of
          every admission, of the first fused tick, of (a)'s first
          verify and (b)'s first decode tick are held against the twin;
          every fused tick and round must make exactly one
          device-to-host fetch.

Each slice's server sets the launch counters to 0 just before its run
and reads them just after; every kernel variant its path runs must have
launched. Then the card's name and power limit, the ``{"kernels":
[...]}`` line (one entry per kernel and page type) and last ``{"ok":
true, "device": {...}}``. Any failed check raises (non-zero exit, no
result line). Without CUDA it exits 2 at once.
"""

import functools
import gc
import json
import math
import subprocess
import sys
import time

# Tolerances, with their reasons.
# Kernel vs plain, bf16 in and out: both sides do all arithmetic in f32
# (they differ by f32 summation order, ~1e-6 relative) and round the
# output to bf16, so an element may differ by the one bf16 step its
# rounding flipped: at most 2^-7 of the element's own magnitude. The
# check is per element and relative, so it keeps its power on long
# rows, whose outputs are small (~0.03): |got - want| <= 2^-7 |want| +
# 1e-5 (the floor covers elements near 0, where the f32 difference
# itself shows). "ulp_ratio" is the worst element's share of its limit.
ULP_REL = 2.0 ** -7
ULP_FLOOR = 1e-5
# Served logits, kernel server vs reference server, relative to the
# largest |logit|: attention outputs round to bf16 in both and a
# rounding flip in one of 18 layers propagates through the bf16
# residual stream. Sound runs read ~5e-3; the limit is 4x that.
LOGIT_REL_TOL = 2e-2

H100_BF16_FLOPS = 989e12      # dense bf16 tensor-core peak (H100 SXM)
H100_HBM_BYTES_S = 3.35e12    # HBM3 rate (H100 SXM)


def mean(xs):
    return sum(xs) / len(xs)


def median(xs):
    return sorted(xs)[len(xs) // 2]


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters, flush):
    """Mean device time of ``fn`` over ``iters`` launches, each timed
    alone with CUDA events after the 50 MB L2 is overwritten (a
    serving tick finds each layer's KV cold)."""
    import torch
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        flush.zero_()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def compare(got, want):
    """Kernel output vs its plain version under the bf16 rule above."""
    d = (got.float() - want.float()).abs()
    w = want.float().abs()
    return {"max_abs_err": d.max().item(),
            "ulp_ratio": (d / (ULP_REL * w + ULP_FLOOR)).max().item(),
            "rel_to_max": (d.max() / w.max()).item()}


def causal_pairs(Sq, Sk, q_offset, window):
    """(query, key) pairs the causal/window mask keeps: the work the
    kernel must do on these inputs."""
    import numpy as np
    qp = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(Sk - 1, qp)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros_like(qp)
    return int(np.maximum(0, hi - lo + 1).sum())


def bound(flops, nbytes):
    t_ops = flops / H100_BF16_FLOPS * 1e3
    t_bytes = nbytes / H100_HBM_BYTES_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def prefill_case(fa, attn, F, torch, dev, flush, name, Sq, Sk, H, Hkv, D,
                 q_offset, window=None, softcap=None, seed=0, fault=False):
    """One prefill shape: check, time, bound. With ``fault``, also run
    the kernel one position off at the causal edge (q_offset + 1, as an
    off-by-one kernel would) and require the same check to reject it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    q = torch.randn(1, Sq, H, D, generator=g, device=dev).to(bf)
    k = torch.randn(1, Sk, Hkv, D, generator=g, device=dev).to(bf)
    v = torch.randn(1, Sk, Hkv, D, generator=g, device=dev).to(bf)
    kw = dict(q_offset=q_offset, window=window, attn_softcap=softcap)
    got = fa.flash_attention(q, k, v, **kw)
    want = attn.mha_reference(q, k, v, **kw)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if not (cmp["ulp_ratio"] <= 1.0):
        raise AssertionError(f"flash_attention {name}: {cmp}")
    fault_ratio = None
    if fault:
        bad = fa.flash_attention(q, k, v, **dict(kw, q_offset=q_offset + 1))
        fault_ratio = compare(bad, want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"flash_attention {name}: the check missed "
                                 f"an off-by-one causal edge ({fault_ratio})")
    iters = 10 if Sq >= 1024 else 30
    ms = time_ms(lambda: fa.flash_attention(q, k, v, **kw), iters, flush)
    plain_ms = time_ms(lambda: attn.mha_reference(q, k, v, **kw), iters,
                       flush)
    library_ms = library_err = None
    if softcap is None:
        # One PyTorch call computing the same function: SDPA with the
        # causal/window mask (timed as a yardstick, never used by the
        # port; it has no softcap).
        qp = q_offset + torch.arange(Sq, device=dev)[:, None]
        kp = torch.arange(Sk, device=dev)[None, :]
        mask = kp <= qp
        if window:
            mask &= kp > qp - window
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=mask, enable_gqa=True)

        lib = sdpa().transpose(1, 2)
        library_err = (lib.float() - want.float()).abs().max().item()
        library_ms = time_ms(sdpa, iters, flush)
    pairs = causal_pairs(Sq, Sk, q_offset, window)
    flops = 4 * D * H * pairs
    nbytes = 2 * (2 * Sq * H * D + 2 * Sk * Hkv * D)
    bms, by = bound(flops, nbytes)
    row = {"phase": "kernels", "kernel": "flash_attention", "case": name,
           "Sq": Sq, "Sk": Sk, "H": H, "Hkv": Hkv, "D": D,
           "q_offset": q_offset, "window": window, "softcap": softcap,
           **cmp, "fault_ulp_ratio": fault_ratio, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_err": library_err, "bound_ms": bms, "bound_by": by,
           "tflops": flops / ms / 1e9}
    emit(row)
    return row


def paged_case(fa, F, torch, np, dev, flush, kernel, name, pos, pages, Sq,
               H, Hkv, D, *, bs=16, nb=1024, mb=None, int8=False,
               window=None, softcap=None, share=None, seed=1, fault=None):
    """One paged-kernel case (``kernel`` is "paged_flash_decode" or
    "paged_flash_verify") over a pool laid out as the server lays it
    out: slot b has ``pages[b]`` pool blocks drawn from a shuffled free
    list, -1 after them; ``share`` = (b0, b1) gives slot b1 slot b0's
    first page (a prefix hit). Slot b's Sq query rows sit at pos[b] ..
    pos[b] + Sq - 1. ``int8``: int8 pages with f32 scale pages, as a
    kv_quant pool holds them. ``fault``: "page" drops one live page of
    the longest slot, "causal" runs the kernel one position late (row s
    attends pos + s + 1), "scale" swaps two heads' scale pages on the
    longest slot's pages; the same check must reject each."""
    from tpushare_torch.models.quant import kv_quantize, scales_to_pool_layout
    B, mb = len(pos), mb or nb
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    k = torch.randn(nb, bs, Hkv, D, generator=g, device=dev)
    v = torch.randn(nb, bs, Hkv, D, generator=g, device=dev)
    scl = {}
    if int8:
        (pool_k, ks), (pool_v, vs) = kv_quantize(k), kv_quantize(v)
        scl = {"k_scale": scales_to_pool_layout(ks),
               "v_scale": scales_to_pool_layout(vs)}
    else:
        pool_k, pool_v = k.to(bf), v.to(bf)
    del k, v
    pos = np.asarray(pos, np.int32)
    table = np.full((B, mb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B):
        table[b, :pages[b]] = [ids.pop() for _ in range(pages[b])]
    if share:
        table[share[1], 0] = table[share[0], 0]
    table_t = torch.as_tensor(table, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    q = torch.randn(B, Sq, H, D, generator=g, device=dev).to(bf)
    kern = getattr(fa, kernel)
    plain = getattr(fa, kernel + "_plain")
    kw = dict(window=window, attn_softcap=softcap, **scl)
    got = kern(q, pool_k, pool_v, table_t, pos_t, **kw)
    want = plain(q, pool_k, pool_v, table_t, pos_t, **kw)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if not (cmp["ulp_ratio"] <= 1.0):
        raise AssertionError(f"{kernel} {name}: {cmp}")
    fault_ratio = None
    if fault:
        b = int(pos.argmax())
        bad_table, bad_pos, bad_kw = table_t, pos_t, kw
        if fault == "page":
            dropped = table.copy()
            dropped[b, int(pos[b]) // bs // 2] = -1
            bad_table = torch.as_tensor(dropped, device=dev)
        elif fault == "causal":
            bad_pos = pos_t + 1
        elif fault == "scale":
            blk = table_t[b, :pages[b]].long()
            bad_kw = dict(kw)
            for key in ("k_scale", "v_scale"):
                sw = kw[key].clone()
                sw[blk, 0], sw[blk, 1] = kw[key][blk, 1], kw[key][blk, 0]
                bad_kw[key] = sw
        bad = kern(q, pool_k, pool_v, bad_table, bad_pos, **bad_kw)
        fault_ratio = compare(bad, want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"{kernel} {name}: the check missed the "
                                 f"planted {fault} fault ({fault_ratio})")
    big = Sq * H >= 1024
    ms = time_ms(lambda: kern(q, pool_k, pool_v, table_t, pos_t, **kw),
                 10 if big else 50, flush)
    plain_ms = time_ms(lambda: plain(q, pool_k, pool_v, table_t, pos_t, **kw),
                       5 if big else 10, flush)
    # The work these inputs need: (row, key) pairs the mask keeps, and
    # the key positions any row of the slot reads.
    kp = np.arange(mb * bs)
    alloc = np.repeat(table >= 0, bs, axis=1)[:, None, :]
    qpos = (pos[:, None] + np.arange(Sq))[..., None]
    keep = (kp <= qpos) & alloc
    if window:
        keep &= kp > qpos - window
    pairs = int(keep.sum())
    live_rows = int(keep.any(axis=1).sum())
    elt = 1 if int8 else 2
    nbytes = (2 * B * Sq * H * D * 2 + 2 * live_rows * Hkv * D * elt
              + (2 * live_rows * Hkv * 4 if int8 else 0) + B * mb * 4 + B * 4)
    flops = 4 * D * H * pairs
    bms, by = bound(flops, nbytes)
    library_ms = library_err = None
    if softcap is None:
        # The library route: gather the live pages into a dense view
        # (int8 pages dequantized), then one SDPA with the boolean mask.
        n = int(max(pages))
        tbl = table_t[:, :n].clamp(min=0).long()
        kpos = torch.arange(n * bs, device=dev)
        qp = pos_t.long()[:, None, None] + torch.arange(Sq, device=dev)[:, None]
        mask = (kpos <= qp) & (table_t[:, :n] >= 0).repeat_interleave(
            bs, dim=1)[:, None, :]
        if window:
            mask &= kpos > qp - window
        mask = mask[:, None]                            # [B, 1, Sq, K]

        def library():
            kd, vd = pool_k[tbl], pool_v[tbl]           # [B, n, bs, Hkv, D]
            if int8:
                kd = (kd.float() * scl["k_scale"][tbl].transpose(-1, -2)
                      [..., None]).to(bf)
                vd = (vd.float() * scl["v_scale"][tbl].transpose(-1, -2)
                      [..., None]).to(bf)
            kd = kd.reshape(B, n * bs, Hkv, D).transpose(1, 2)
            vd = vd.reshape(B, n * bs, Hkv, D).transpose(1, 2)
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), kd, vd, attn_mask=mask,
                enable_gqa=True).transpose(1, 2)

        rows = torch.as_tensor(keep.any(axis=2), device=dev)  # [B, Sq]
        lib = library()
        library_err = (lib.float() - want.float()).abs()[rows].max().item()
        library_ms = time_ms(library, 5 if big else 10, flush)
    row = {"phase": "kernels", "kernel": kernel, "case": name,
           "pages": "int8" if int8 else "bf16", "B": B, "Sq": Sq, "H": H,
           "Hkv": Hkv, "D": D, "bs": bs, "max_pos": int(pos.max()),
           "live_rows": live_rows, "window": window, "softcap": softcap,
           **cmp, "fault": fault, "fault_ulp_ratio": fault_ratio, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_calls": ("gather, dequantize, SDPA" if int8
                             else "gather, SDPA"),
           "library_err": library_err, "bound_ms": bms, "bound_by": by,
           "gb_s": nbytes / ms / 1e6}
    emit(row)
    return row


class RecordingSampler:
    """Wraps a server's sampler to keep the logits of the picks made
    while ``record`` is set (the check compares them across two
    servers)."""

    def __init__(self, inner):
        self.inner, self.record, self.seen = inner, False, []

    def pick(self, logits):
        if self.record:
            self.seen.append(logits.detach().float().clone())
        return self.inner.pick(logits)


class DeviceProfile:
    """Device time by kernel name over a window of ``n`` steps, and the
    share of that same window's wall time the card sat idle
    (torch.profiler over CUPTI, CUDA activity only: no host-op tracing,
    so the host runs close to its unprofiled pace; ``wall_ms_per_tick``
    beside the unprofiled ticks' shows what the profiler still
    costs)."""

    def __init__(self, n):
        self.n, self.stats = n, None

    def __enter__(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        import torch
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - self.t0) * 1e3
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return
        n, by_name = self.n, {}
        for evt in self.prof.key_averages():
            if evt.device_type != torch.autograd.DeviceType.CUDA:
                continue
            by_name[evt.key[:90]] = evt.self_device_time_total / 1e3 / n
        busy = sum(by_name.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        self.stats = {"ticks": n, "wall_ms_per_tick": wall_ms / n,
                      "device_ms_per_tick": busy,
                      "idle_share": 1.0 - busy * n / wall_ms,
                      "top_kernels_ms_per_tick": dict(top)}


def profile_ticks(srv, n):
    """``DeviceProfile`` of ``n`` decode ticks of ``srv``."""
    with DeviceProfile(n) as prof:
        for _ in range(n):
            srv.step()
    return prof.stats


def serve(paged, cfg, params, prompts, wave2, attn_impl, ticks,
          profile=0):
    """Drive one server through the main path; returns what it served,
    the recorded logits, the decode timing and, with ``profile`` > 0,
    a device-time breakdown of that many further decode ticks."""
    import torch
    srv = paged.PagedSlotServer(params, cfg, n_slots=8, n_blocks=1024,
                                block_size=16, prefix_cache=True,
                                attn_impl=attn_impl)
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    first, streams = {}, {}
    torch.cuda.synchronize()
    rec.record = True               # wave-1 admissions and first tick
    t0 = time.perf_counter()
    for i, p in enumerate(prompts):
        slot = srv.admit_start(p)
        first[i] = srv.admit_step(slot)
        streams[slot] = [first[i]]
    torch.cuda.synchronize()
    admit_s = time.perf_counter() - t0
    tick_ms = []
    for t in range(ticks):
        t0 = time.perf_counter()
        out = srv.step()                        # ends in the tick's fetch
        tick_ms.append((time.perf_counter() - t0) * 1e3)
        for s, tok in out.items():
            streams[s].append(tok)
        if t == 0:
            rec.record = False
            active = [sorted(out)]
    decode_s = sum(tick_ms) / 1e3
    prof = profile_ticks(srv, profile) if profile else None
    for s in list(streams):
        srv.evict(s)
    hits = []
    rec.record = True               # wave-2 admissions and first tick
    for p in wave2:
        slot = srv.admit_start(p)
        hits.append(srv.last_cached_len)
        streams[100 + slot] = [srv.admit_step(slot)]
    for t in range(8):
        out = srv.step()
        for s, tok in out.items():
            streams[100 + s].append(tok)
        if t == 0:
            rec.record = False
            active.append(sorted(out))
    torch.cuda.synchronize()
    # Rows to compare in each recorded pick: an admission's one row;
    # a tick's active slots (an idle slot's row is junk in both servers
    # and differs between them: the kernel gives a slot with no live
    # page 0, the reference's gathered view reads the trash block).
    n1 = len(prompts)
    rows = [[0]] * n1 + [active[0]] + [[0]] * len(wave2) + [active[1]]
    return {"first": first, "streams": streams, "logits": rec.seen,
            "rows": rows,
            "hits": hits, "admit_s": admit_s, "decode_s": decode_s,
            "tick_ms_median": median(tick_ms),
            "fetches": srv.device_fetches, "profile": prof}


class FetchSpy:
    """Counts every way a tensor's value reaches the host (.item,
    .tolist, .cpu, .numpy and the scalar conversions) while active."""

    NAMES = ("cpu", "item", "tolist", "numpy", "__bool__", "__int__",
             "__float__", "__index__")

    def __init__(self, torch):
        self.torch, self.count = torch, 0

    def __enter__(self):
        T = self.torch.Tensor
        self.orig = {n: getattr(T, n) for n in self.NAMES}

        def spy(fn):
            def wrapped(t, *a, **kw):
                self.count += 1
                return fn(t, *a, **kw)
            return wrapped

        for n, fn in self.orig.items():
            setattr(T, n, spy(fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.orig.items():
            setattr(self.torch.Tensor, n, fn)


def llama_schedule(serving, paged, wave_a, wave_b, chunk, bs, h):
    """The Llama slice's launch shapes, from the server's own rules
    (serving.fused_chunk_span, paged.blocks_needed) on the host: each
    fused tick's (width, pos [8], pages [8]) with slots 0-3 decoding and
    the admitting slot at its chunk start, and each slot's length when
    the fused admissions end (the first speculative round's base and the
    kv_quant server's first decode position)."""
    lengths = {s: n for s, n in enumerate(wave_a)}
    ticks = []
    for i, S in enumerate(wave_b):
        slot, done = len(wave_a) + i, 0
        while done < S:
            end, width = serving.fused_chunk_span(done, S, chunk, None,
                                                  gran=bs)
            pos = [lengths.get(s, 0) for s in range(8)]
            pages = [lengths[s] // bs + 1 if s in lengths else 0
                     for s in range(8)]
            pos[slot], pages[slot] = done, paged.blocks_needed(S + 1, bs)
            ticks.append((width, pos, pages))
            for s in lengths:
                lengths[s] += 1
            done = end
        lengths[slot] = S
    base = [lengths[s] for s in range(8)]
    return ticks, base, [(n + h) // bs + 1 for n in base]


def serve_llama(paged, quant, cfg, params, qparams, wave_a, wave_b, *,
                mode, attn_impl, rounds, n_blocks, chunk):
    """Drive one Llama-3-8B server through the slice: 4 whole
    admissions, 4 admissions by fused ticks, then ``rounds``
    speculative rounds (mode "spec") or decode ticks (mode "kvq").
    Returns streams, recorded logits (admissions, the first fused
    tick's decode rows, the first verify or decode tick), timings,
    fetch counts per fused tick and round, and peak memory."""
    import torch
    kw = dict(n_slots=8, n_blocks=n_blocks, block_size=16,
              max_blocks_per_slot=256, prefix_cache=True,
              attn_impl=attn_impl)
    if mode == "spec":
        kw.update(speculative_draft=(qparams, cfg), gamma=4,
                  draft_layers_hook=quant.dequant_hook(cfg))
    else:
        kw.update(kv_quant=True)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    srv = paged.PagedSlotServer(params, cfg, **kw)
    rec = RecordingSampler(srv._sampler)
    srv._sampler = rec
    streams, inputs = {}, {}
    torch.cuda.synchronize()
    rec.record = True
    t0 = time.perf_counter()
    for p in wave_a:
        slot = srv.admit_start(p)
        streams[slot] = [srv.admit_step(slot)]
    admit_s = time.perf_counter() - t0
    n_adm_a = len(rec.seen)
    fused_ms, fused_fetch, first_tick = [], [], None
    t_fused = time.perf_counter()
    for i, p in enumerate(wave_b):
        slot = srv.admit_start(p, chunk_tokens=chunk)
        if i == len(wave_b) - 1:
            # The last admission's fused ticks run under the profiler;
            # their times stay out of the unprofiled mean.
            n_plain = len(fused_ms)
            prof_fused = DeviceProfile(
                -(-len(p) // chunk)).__enter__()
        while slot in srv._admissions:
            before = {s: v[-1] for s, v in streams.items()}
            f0 = srv.device_fetches
            t0 = time.perf_counter()
            with FetchSpy(torch) as spy:
                out = srv.step(prefill_work=slot)      # ends in its fetch
            fused_ms.append((time.perf_counter() - t0) * 1e3)
            fused_fetch.append((spy.count, srv.device_fetches - f0))
            if first_tick is None:
                first_tick = len(rec.seen) - 1   # the decode rows' pick
                inputs["fused"] = before
            for s, t in out.items():
                streams.setdefault(s, []).append(t)
    prof_fused.__exit__(None, None, None)
    fused_s = time.perf_counter() - t_fused
    # Picks kept: every admission's [1, V] row, and the first fused
    # tick's decode rows; the later fused ticks' picks are dropped.
    adm = [i for i, x in enumerate(rec.seen) if x.shape[0] == 1]
    keep = sorted(set(adm) | {first_tick})
    logits = [rec.seen[i] for i in keep]
    rec.record, rec.seen = False, []
    verify = {}
    if mode == "spec":
        inner = srv._spec_verify

        def spec_verify(block, base):
            tl = inner(block, base)
            if not verify:
                verify.update(block=block.clone(), tl=tl.float().clone())
            return tl
        srv._spec_verify = spec_verify
    round_ms, round_fetch, emitted = [], [], 0
    inputs["step"] = {s: v[-1] for s, v in streams.items()}
    for r in range(rounds):
        if r == 0 and mode == "kvq":
            rec.record = True
        f0 = srv.device_fetches
        t0 = time.perf_counter()
        with FetchSpy(torch) as spy:
            out = srv.step()
        round_ms.append((time.perf_counter() - t0) * 1e3)
        round_fetch.append((spy.count, srv.device_fetches - f0))
        rec.record = False
        for s, t in out.items():
            t = t if isinstance(t, list) else [t]
            streams[s].extend(t)
            emitted += len(t)
    # Two more rounds (ticks) under the profiler, outside the timed ones.
    with DeviceProfile(2) as prof_step:
        for _ in range(2):
            for s, t in srv.step().items():
                streams[s].extend(t if isinstance(t, list) else [t])
    torch.cuda.synchronize()
    res = {"streams": streams, "logits": logits, "inputs": inputs,
           "first_tick_rows": sorted(inputs["fused"]),
           "verify": verify, "step_logits": rec.seen,
           "admit_s": admit_s, "fused_s": fused_s, "fused_ms": fused_ms,
           "fused_fetch": fused_fetch, "fused_ms_unprofiled":
           fused_ms[:n_plain], "fused_profile": prof_fused.stats,
           "step_profile": prof_step.stats, "round_ms": round_ms,
           "round_fetch": round_fetch, "emitted": emitted,
           "accept_rate": (srv.spec_accept_rate() if mode == "spec"
                           else None),
           "fetches": srv.device_fetches,
           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
           "lengths": srv.cache.host_lengths().tolist()}
    # The verify wrapper above closes over the server: break the cycle
    # so its pools are freed now, before the next server allocates.
    srv.__dict__.pop("_spec_verify", None)
    del srv, rec
    gc.collect()
    torch.cuda.empty_cache()
    return res


def llama_logit_checks(torch, run, ref, mode):
    """Largest |run - ref| / max |ref| of each compared logits row:
    every admission, the first fused tick's decode rows, and (a) the
    first verify's positions whose block prefix both servers share or
    (b) the first decode tick's rows whose input token both share."""
    def rel(a, b):
        if not torch.isfinite(a).all():
            raise AssertionError("served logits are not finite")
        return ((a - b).abs().max() / b.abs().max()).item()

    if len(run["logits"]) != len(ref["logits"]):
        raise AssertionError("the two servers recorded different picks")
    out = {"admissions": [], "first_fused_tick": [], "first_step": []}
    for a, b in zip(run["logits"], ref["logits"]):
        if a.shape != b.shape:
            raise AssertionError("served logits are not shaped alike")
        if a.shape[0] == 1:
            out["admissions"].append(rel(a, b))
        else:
            for s in run["first_tick_rows"]:
                if run["inputs"]["fused"][s] == ref["inputs"]["fused"][s]:
                    out["first_fused_tick"].append(rel(a[s], b[s]))
    if mode == "spec":
        ba, bb = run["verify"]["block"], ref["verify"]["block"]
        for s in range(ba.shape[0]):
            for j in range(ba.shape[1]):
                if not torch.equal(ba[s, :j + 1], bb[s, :j + 1]):
                    break
                out["first_step"].append(rel(run["verify"]["tl"][s, j],
                                             ref["verify"]["tl"][s, j]))
    else:
        a, b = run["step_logits"][0], ref["step_logits"][0]
        for s, t in run["inputs"]["step"].items():
            if t == ref["inputs"]["step"][s]:
                out["first_step"].append(rel(a[s], b[s]))
    if len(out["admissions"]) != 8 or not out["first_fused_tick"] \
            or not out["first_step"]:
        raise AssertionError(f"too few logits rows compared: "
                             f"{ {k: len(v) for k, v in out.items()} }")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    import importlib

    import numpy as np
    import torch.nn.functional as F

    from tpushare_torch.models import paged, quant, serving
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.ops import _build
    fa = importlib.import_module("tpushare_torch.ops.flash_attention")
    attn = importlib.import_module("tpushare_torch.ops.attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi()
    t_start = time.perf_counter()
    emit({"phase": "env", "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card})

    t0 = time.perf_counter()
    logs = _build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": sorted(logs),
          "ptxas": {n: [ln.strip() for ln in log.splitlines()
                        if "registers" in ln or "spill" in ln][:4]
                    for n, log in logs.items()}})

    # The slices' workloads, fixed first so the kernels phase can test
    # exactly the shapes the slices will launch.
    cfg = tt.gemma_2b()
    bs, n_blocks, ticks = 16, 1024, 32
    rng = np.random.default_rng(0)
    lengths = [16, 100, 255, 511, 700, 1024, 1500, 2048]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    shared = [(7, 1024, 200), (4, 512, 64)]     # (prompt, prefix, new)
    wave2 = [np.concatenate([prompts[i][:n], rng.integers(0, cfg.vocab_size,
                                                          m)])
             for i, n, m in shared]
    lcfg = tt.llama3_8b()
    l_blocks, l_mb, chunk, gamma, rounds = 8 * 256 + 1, 256, 512, 4, 16
    la_len, lb_len = [100, 511, 1024, 2048], [700, 1500, 2048, 3000]
    lrng = np.random.default_rng(1)
    wave_a = [lrng.integers(0, lcfg.vocab_size, n) for n in la_len]
    wave_b = [lrng.integers(0, lcfg.vocab_size, n) for n in lb_len]

    # Prefill launches: each whole admission attends its whole padded
    # row, Sq = comp_len - cached_len queries at q_offset cached_len
    # over Sk = comp_len keys (the Gemma slice's second wave reuses its
    # whole shared prefix, which the slice checks below).
    def prefill_shapes(admissions, nb):
        out = []
        for S, cached in admissions:
            _, comp = paged.admission_len(S, cached, bs, nb)
            if (comp - cached, comp, cached) not in out:
                out.append((comp - cached, comp, cached))
        return out

    path_shapes = prefill_shapes(
        [(len(p), 0) for p in prompts]
        + [(len(p), n) for p, (_, n, _) in zip(wave2, shared)], n_blocks)
    l_shapes = prefill_shapes([(n, 0) for n in la_len], l_mb)

    def work(sh):
        return causal_pairs(sh[0], sh[1], sh[2], None)
    # The planted causal-edge fault goes on the largest prefix-hit case.
    fault_shape = max((sh for sh in path_shapes if sh[2] > 0), key=work)
    # Decode positions of the Gemma slice's last wave-1 tick.
    dec_pos = [n + ticks - 1 for n in lengths]
    dec_pages = [p // bs + 1 for p in dec_pos]
    # The Llama slice: fused ticks' shapes, and the lengths its
    # speculative round / first decode tick start from.
    l_ticks, l_base, l_spec_pages = llama_schedule(
        serving, paged, la_len, lb_len, chunk, bs, gamma)
    widths = sorted({w for w, _, _ in l_ticks})
    fused_cases = []
    for w in widths:      # the tick of each width with the most context
        _, pos, pages = max((t for t in l_ticks if t[0] == w),
                            key=lambda t: sum(t[1]))
        fused_cases.append((w, pos, pages))

    t_k = time.perf_counter()
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    pre_g = [
        prefill_case(fa, attn, F, torch, dev, flush,
                     f"gemma2b_sq{Sq}_sk{Sk}_off{off}", Sq, Sk, 8, 1, 256,
                     q_offset=off, fault=(Sq, Sk, off) == fault_shape)
        for Sq, Sk, off in path_shapes]
    pre_l = [
        prefill_case(fa, attn, F, torch, dev, flush,
                     f"llama3_8b_sq{Sq}_sk{Sk}_off{off}", Sq, Sk, 32, 8,
                     128, q_offset=off)
        for Sq, Sk, off in l_shapes]
    pre = pre_g + pre_l + [
        prefill_case(fa, attn, F, torch, dev, flush,
                     "gemma2_window_softcap", 512, 1024, 8, 4, 256,
                     q_offset=512, window=256, softcap=50.0),
    ]
    pc = functools.partial(paged_case, fa, F, torch, np, dev, flush)
    dec = [
        pc("paged_flash_decode", "gemma2b_b8", dec_pos, dec_pages, 1, 8, 1,
           256, share=(2, 5), fault="page"),
        pc("paged_flash_decode", "llama3_8b_draft_b8", l_base,
           l_spec_pages, 1, 32, 8, 128, nb=l_blocks, mb=l_mb),
        pc("paged_flash_decode", "gemma2_window_softcap", dec_pos,
           dec_pages, 1, 8, 4, 256, window=1024, softcap=50.0,
           share=(2, 5)),
    ]
    dec8 = [
        pc("paged_flash_decode", "llama3_8b_kvq_b8", l_base,
           [n // bs + 1 for n in l_base], 1, 32, 8, 128, nb=l_blocks,
           mb=l_mb, int8=True, fault="scale"),
    ]
    ver, ver8 = [], []
    for int8, out in ((False, ver), (True, ver8)):
        tag = "_int8" if int8 else ""
        out.append(pc("paged_flash_verify", f"llama3_8b_spec_sq5{tag}",
                      l_base, l_spec_pages, gamma + 1, 32, 8, 128,
                      nb=l_blocks, mb=l_mb, int8=int8,
                      fault="scale" if int8 else "causal"))
        for w, pos, pages in fused_cases:
            out.append(pc("paged_flash_verify",
                          f"llama3_8b_fused_sq{w}{tag}", pos, pages, w,
                          32, 8, 128, nb=l_blocks, mb=l_mb, int8=int8,
                          fault=None if int8 else "causal"))
    ver += [
        pc("paged_flash_verify", "gemma2b_sq5", dec_pos,
           [(p + gamma) // bs + 1 for p in dec_pos], gamma + 1, 8, 1, 256,
           share=(2, 5)),
        pc("paged_flash_verify", "gemma2_window_softcap_sq5", dec_pos,
           [(p + gamma) // bs + 1 for p in dec_pos], gamma + 1, 8, 4, 256,
           window=1024, softcap=50.0, share=(2, 5)),
    ]
    del flush
    kernels_s = time.perf_counter() - t_k

    # -- slice: Gemma-2B at full width over the paged pool -------------
    t_g = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.perf_counter()
    params = tt.init_params(gen, cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    # Warm-up: one short pass of the same workload through the plain
    # path, so neither timed server pays the process's first cuBLAS
    # choices and allocator growth for every GEMM shape (the first
    # server to run would otherwise carry them alone).
    serve(paged, cfg, params, prompts, wave2, "reference", 2)
    torch.cuda.empty_cache()

    counters = (("flash_attention", fa.flash_attention, "launches"),
                ("paged_flash_decode", fa.paged_flash_decode, "launches"),
                ("paged_flash_decode_int8", fa.paged_flash_decode,
                 "launches_int8"),
                ("paged_flash_verify", fa.paged_flash_verify, "launches"),
                ("paged_flash_verify_int8", fa.paged_flash_verify,
                 "launches_int8"))

    def zero_counts():
        for _, fn, attr in counters:
            setattr(fn, attr, 0)

    def read_counts():
        return {name: getattr(fn, attr) for name, fn, attr in counters}

    def run_path(needed, fn, *a, **kw):
        """Drive one main path with every count zeroed just before and
        read just after; each kernel variant in ``needed`` must have
        launched."""
        zero_counts()
        out = fn(*a, **kw)
        got = read_counts()
        for name in needed:
            if got[name] <= 0:
                raise AssertionError(f"{name} was not launched on the "
                                     f"main path")
        return out, got

    def no_launch(fn, *a, **kw):
        """A reference twin: must launch no kernel at all."""
        zero_counts()
        out = fn(*a, **kw)
        if any(read_counts().values()):
            raise AssertionError(f"a reference server launched a kernel: "
                                 f"{read_counts()}")
        return out

    run, launches = run_path(
        ("flash_attention", "paged_flash_decode"), serve, paged, cfg,
        params, prompts, wave2, "auto", ticks, profile=4)
    ref = no_launch(serve, paged, cfg, params, prompts, wave2, "reference",
                    ticks, profile=4)
    V = cfg.vocab_size
    toks = [t for s in run["streams"].values() for t in s]
    if not all(0 <= t < V for t in toks):
        raise AssertionError("a served token is outside [0, V)")
    if run["hits"] != [n for _, n, _ in shared]:
        raise AssertionError(f"second wave's prefix hits {run['hits']}, "
                             f"expected the whole shared prefix")
    rel = []
    if run["rows"] != ref["rows"]:
        raise AssertionError("the two servers' active slots differ")
    for a, b, r in zip(run["logits"], ref["logits"], run["rows"]):
        if a.shape != b.shape:
            raise AssertionError("served logits are not shaped alike")
        a, b = a[r], b[r]
        if not torch.isfinite(a).all():
            raise AssertionError("served logits are not finite")
        rel.append(((a - b).abs().max() / b.abs().max()).item())
    # 8 + 2 admissions, and the first tick of each wave.
    n_rec = len(prompts) + len(wave2) + 2
    if len(rel) != n_rec or len(ref["logits"]) != n_rec:
        raise AssertionError(f"recorded {len(rel)} logit rows, "
                             f"expected {n_rec}")
    worst = max(rel)
    if not (worst <= LOGIT_REL_TOL):
        raise AssertionError(f"logits vs reference server: {rel}")
    agree = sum(int(x == y) for k in run["streams"]
                for x, y in zip(run["streams"][k], ref["streams"][k]))
    emit({"phase": "slice", "model": "gemma_2b", "params": cfg.num_params(),
          "init_s": init_s, "prompt_lengths": lengths,
          "wave2_cached_len": run["hits"], "prefill_shapes": path_shapes,
          "decode_ticks": ticks, "launches": launches,
          "first_tokens": list(run["first"].values()),
          "logit_rel_err_max": worst, "logit_rel_err": rel,
          "logit_rel_tol": LOGIT_REL_TOL,
          "greedy_agreement": agree / len(toks),
          "admit_s": run["admit_s"], "ref_admit_s": ref["admit_s"],
          "decode_ms_per_tick": run["decode_s"] / ticks * 1e3,
          "decode_tok_s": len(prompts) * ticks / run["decode_s"],
          "ref_decode_ms_per_tick": ref["decode_s"] / ticks * 1e3,
          "decode_ms_per_tick_median": run["tick_ms_median"],
          "ref_decode_ms_per_tick_median": ref["tick_ms_median"],
          "ref_profile": ref["profile"],
          "fetches": run["fetches"], "profile": run["profile"],
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
          "seconds": time.perf_counter() - t_g, "card": card})
    del params, run, ref
    torch.cuda.empty_cache()

    # -- slice_llama: Llama-3-8B at full width, speculative + fused + int8
    t_l = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1)
    t0 = time.perf_counter()
    lparams = tt.init_params(gen, lcfg)
    qparams = quant.quantize_params(lparams, lcfg)
    torch.cuda.synchronize()
    l_init_s = time.perf_counter() - t0
    common = dict(wave_a=wave_a, wave_b=wave_b, rounds=rounds,
                  n_blocks=l_blocks, chunk=chunk)
    l_launches = {}
    for mode, needed in (
            ("spec", ("flash_attention", "paged_flash_decode",
                      "paged_flash_verify")),
            ("kvq", ("flash_attention", "paged_flash_decode_int8",
                     "paged_flash_verify_int8"))):
        kw = dict(common, mode=mode)
        lrun, l_launches[mode] = run_path(
            needed, serve_llama, paged, quant, lcfg, lparams, qparams,
            attn_impl="auto", **kw)
        lref = no_launch(serve_llama, paged, quant, lcfg, lparams, qparams,
                         attn_impl="reference", **kw)
        checks = llama_logit_checks(torch, lrun, lref, mode)
        worst_l = max(max(v) for v in checks.values())
        if not (worst_l <= LOGIT_REL_TOL):
            raise AssertionError(f"Llama {mode} logits vs reference twin: "
                                 f"{checks}")
        for what, fetches in (("fused tick", lrun["fused_fetch"]),
                              ("round" if mode == "spec" else "tick",
                               lrun["round_fetch"])):
            if any(f != (1, 1) for f in fetches):
                raise AssertionError(f"Llama {mode}: a {what} made other "
                                     f"than one fetch: {fetches}")
        ltoks = [t for v in lrun["streams"].values() for t in v]
        if not all(0 <= t < lcfg.vocab_size for t in ltoks):
            raise AssertionError("a served token is outside [0, V)")
        # Every served token advanced its slot by one position.
        want_len = [n + len(lrun["streams"][s]) - 1
                    for s, n in enumerate(la_len + lb_len)]
        if lrun["lengths"] != want_len:
            raise AssertionError(f"Llama {mode}: lengths {lrun['lengths']} "
                                 f"!= prompts + served tokens {want_len}")
        agree = sum(int(x == y) for s in lrun["streams"]
                    for x, y in zip(lrun["streams"][s], lref["streams"][s]))
        step = "round" if mode == "spec" else "tick"
        emit({
            "phase": "slice_llama", "server": mode, "model": "llama3_8b",
            "params": lcfg.num_params(), "init_s": l_init_s,
            "wave_a": la_len, "wave_b": lb_len, "chunk_tokens": chunk,
            "fused_widths": [w for w, _, _ in l_ticks],
            "gamma": gamma if mode == "spec" else None,
            "launches": l_launches[mode], "logit_rel_err": checks,
            "logit_rel_err_max": worst_l, "logit_rel_tol": LOGIT_REL_TOL,
            "greedy_agreement": agree / len(ltoks),
            "admit_s": lrun["admit_s"], "ref_admit_s": lref["admit_s"],
            "fused_ticks": len(lrun["fused_ms"]),
            "fused_ms_per_tick": mean(lrun["fused_ms_unprofiled"]),
            "ref_fused_ms_per_tick": mean(lref["fused_ms_unprofiled"]),
            "fused_profile": lrun["fused_profile"],
            "ref_fused_profile": lref["fused_profile"],
            f"ms_per_{step}": mean(lrun["round_ms"]),
            f"ms_per_{step}_median": median(lrun["round_ms"]),
            f"ref_ms_per_{step}": mean(lref["round_ms"]),
            f"{step}_profile": lrun["step_profile"],
            f"ref_{step}_profile": lref["step_profile"],
            "tok_s": lrun["emitted"] / (sum(lrun["round_ms"]) / 1e3),
            "ref_tok_s": lref["emitted"] / (sum(lref["round_ms"]) / 1e3),
            "accept_rate": lrun["accept_rate"],
            "ref_accept_rate": lref["accept_rate"],
            "fetches_per_fused_tick": sorted({f for f, _ in
                                              lrun["fused_fetch"]}),
            f"fetches_per_{step}": sorted({f for f, _ in
                                           lrun["round_fetch"]}),
            "fetches": lrun["fetches"],
            "peak_mem_gib": lrun["peak_mem_gib"],
            "ref_peak_mem_gib": lref["peak_mem_gib"],
            "seconds": time.perf_counter() - t_l, "card": card})
        del lrun, lref
    del lparams, qparams
    torch.cuda.empty_cache()

    # The kernels line: one entry per kernel and page type, timed at
    # its largest main-path case; launches summed over the paths' runs.
    def total(name):
        return launches.get(name, 0) + sum(c[name] for c in
                                           l_launches.values())

    def entry(name, source, replaces, path_cases, all_cases):
        """Times from the variant's largest main-path case; the check
        columns over every case of the variant, the extra geometries'
        too."""
        main = max(path_cases, key=lambda r: r["bound_ms"])
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "pages": main.get("pages"),
                "launches": total(name),
                "launches_by_path": {
                    "slice": launches.get(name, 0),
                    **{f"slice_llama_{m}": c[name]
                       for m, c in l_launches.items()}},
                "max_abs_err": max(r["max_abs_err"] for r in all_cases),
                "ulp_ratio": max(r["ulp_ratio"] for r in all_cases),
                "ms": main["ms"], "plain_ms": main["plain_ms"],
                "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "library_ms": main["library_ms"],
                "library_calls": main.get("library_calls", "SDPA"),
                "case": main["case"]}

    src = "tpushare_torch/csrc/"
    ref_fa = "tpushare/ops/flash_attention.py:"
    kernels = [
        dict(entry("flash_attention", src + "flash_prefill.cu",
                   ref_fa + "105", pre_g + pre_l, pre),
             also_replaces=ref_fa + "180"),
        entry("paged_flash_decode", src + "paged_decode.cu", ref_fa + "659",
              dec[:2], dec),
        entry("paged_flash_decode_int8", src + "paged_decode.cu",
              ref_fa + "659", dec8, dec8),
        entry("paged_flash_verify", src + "paged_verify.cu", ref_fa + "843",
              ver[:1 + len(fused_cases)], ver),
        entry("paged_flash_verify_int8", src + "paged_verify.cu",
              ref_fa + "843", ver8, ver8),
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "library_ms",
                    "max_abs_err"):
            if not (isinstance(k[key], float) and math.isfinite(k[key])):
                raise AssertionError(f"{k['name']}: {key} = {k[key]}")
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']}: no launch on a main path")
    emit({"phase": "seconds", "kernels": kernels_s,
          "total": time.perf_counter() - t_start})
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
