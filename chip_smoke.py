#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that the PyTorch/CUDA port
(tpushare_torch) still starts and serves on an NVIDIA GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, one JSON line each:

  env     torch/CUDA versions, the card's name and power limit.
  build   compiles every kernel of the main path from tpushare_torch/csrc
          (one nvcc per source, started together) and times it.
  kernels each kernel against its plain PyTorch version on the card:
          prefill at every shape the slice below launches (derived from
          the admission's padding rule, paged.admission_len), decode at
          the slice's positions, plus Llama-3-8B and Gemma-2 window +
          softcap cases; with the kernel's time, the plain version's,
          one PyTorch library call's where one computes the same
          function, and the least time the card could take (bound). On
          one case per kernel a planted fault (an off-by-one causal
          edge, a dropped page) must fail the same check.
  slice   Gemma-2B at full width (random bf16 weights from a seeded
          generator) served by PagedSlotServer over the paged KV pool:
          8 prompts of 16..2048 tokens, 32 greedy decode ticks (then 4
          more under torch.profiler, CUDA activity only: device time by
          kernel and the card's idle share in that window), evict, then
          a second wave whose prompts hit the prefix cache, 8 ticks. A
          short untimed pass of the same workload on the plain path
          warms cuBLAS and the allocator first. The launch counters are
          zeroed just before the kernel run and read just after it; a
          second server on the same weights with
          attn_impl="reference" checks the logits of every admission
          (both waves) and of each wave's first tick.

Then the card's name and power limit, the ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Any failed check raises
(non-zero exit, no result line). Without CUDA it exits 2 at once.
"""

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


def decode_case(fa, torch, np, dev, flush, name, pos, H, Hkv, D,
                window=None, softcap=None, bs=16, nb=1024, seed=1,
                fault=False):
    """Ragged decode over a pool laid out as the server lays it out:
    slot b holds pos[b]+1 positions in blocks drawn from a shuffled
    free list, -1 past its live pages, slots 2 and 5 share a prefix
    page (a prefix hit). With ``fault``, also run the kernel with one
    live page of the longest slot dropped (its entry set to -1, as a
    kernel that skipped a page would) and require the same check to
    reject it."""
    B = len(pos)
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    bf = torch.bfloat16
    pool_k = torch.randn(nb, bs, Hkv, D, generator=g, device=dev).to(bf)
    pool_v = torch.randn(nb, bs, Hkv, D, generator=g, device=dev).to(bf)
    pos = np.asarray(pos, np.int32)
    table = np.full((B, nb), -1, np.int32)
    ids = list(rng.permutation(nb - 1))
    for b in range(B):
        n = int(pos[b]) // bs + 1
        table[b, :n] = [ids.pop() for _ in range(n)]
    table[5, 0] = table[2, 0]
    table_t = torch.as_tensor(table, device=dev)
    pos_t = torch.as_tensor(pos, device=dev)
    q = torch.randn(B, 1, H, D, generator=g, device=dev).to(bf)
    kw = dict(window=window, attn_softcap=softcap)
    got = fa.paged_flash_decode(q, pool_k, pool_v, table_t, pos_t, **kw)
    want = fa.paged_flash_decode_plain(q, pool_k, pool_v, table_t, pos_t,
                                       **kw)
    torch.cuda.synchronize()
    cmp = compare(got, want)
    if not (cmp["ulp_ratio"] <= 1.0):
        raise AssertionError(f"paged_flash_decode {name}: {cmp}")
    fault_ratio = None
    if fault:
        b = int(pos.argmax())
        dropped = table.copy()
        dropped[b, int(pos[b]) // bs // 2] = -1
        bad = fa.paged_flash_decode(q, pool_k, pool_v,
                                    torch.as_tensor(dropped, device=dev),
                                    pos_t, **kw)
        fault_ratio = compare(bad, want)["ulp_ratio"]
        if not (fault_ratio > 1.0):
            raise AssertionError(f"paged_flash_decode {name}: the check "
                                 f"missed a dropped page ({fault_ratio})")
    ms = time_ms(lambda: fa.paged_flash_decode(
        q, pool_k, pool_v, table_t, pos_t, **kw), 50, flush)
    plain_ms = time_ms(lambda: fa.paged_flash_decode_plain(
        q, pool_k, pool_v, table_t, pos_t, **kw), 10, flush)
    live = np.minimum(pos + 1, window) if window else pos + 1
    live_rows = int(live.sum())
    nbytes = (2 * live_rows * Hkv * D * 2 + 2 * B * H * D * 2
              + B * 4 + sum(-(-int(p + 1) // bs) for p in pos) * 4)
    flops = 4 * D * H * live_rows
    bms, by = bound(flops, nbytes)
    row = {"phase": "kernels", "kernel": "paged_flash_decode", "case": name,
           "B": B, "H": H, "Hkv": Hkv, "D": D, "bs": bs,
           "max_pos": int(pos.max()), "live_rows": live_rows,
           "window": window, "softcap": softcap, **cmp,
           "fault_ulp_ratio": fault_ratio, "ms": ms, "plain_ms": plain_ms,
           "library_ms": None, "bound_ms": bms, "bound_by": by,
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


def profile_ticks(srv, n):
    """Device time of ``n`` decode ticks by kernel name, and the share
    of that same window's wall time the card sat idle (torch.profiler
    over CUPTI, CUDA activity only: no host-op tracing, so the host
    runs close to its unprofiled pace; ``wall_ms_per_tick`` beside the
    unprofiled ticks' shows what the profiler still costs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            srv.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        by_name[evt.key[:90]] = evt.self_device_time_total / 1e3 / n
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {"ticks": n, "wall_ms_per_tick": wall_ms / n,
            "device_ms_per_tick": busy,
            "idle_share": 1.0 - busy * n / wall_ms,
            "top_kernels_ms_per_tick": dict(top)}


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
            "tick_ms_median": sorted(tick_ms)[len(tick_ms) // 2],
            "fetches": srv.device_fetches, "profile": prof}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    import importlib

    import numpy as np
    import torch.nn.functional as F

    from tpushare_torch.models import paged
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.ops import _build
    fa = importlib.import_module("tpushare_torch.ops.flash_attention")
    attn = importlib.import_module("tpushare_torch.ops.attention")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = nvidia_smi()
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

    # The slice's workload, fixed first so the kernels phase can test
    # exactly the shapes the slice will launch.
    cfg = tt.gemma_2b()
    bs, n_blocks, ticks = 16, 1024, 32
    rng = np.random.default_rng(0)
    lengths = [16, 100, 255, 511, 700, 1024, 1500, 2048]
    prompts = [rng.integers(0, cfg.vocab_size, n) for n in lengths]
    shared = [(7, 1024, 200), (4, 512, 64)]     # (prompt, prefix, new)
    wave2 = [np.concatenate([prompts[i][:n], rng.integers(0, cfg.vocab_size,
                                                          m)])
             for i, n, m in shared]
    # Prefill launches of the slice: each admission attends its whole
    # padded row, Sq = comp_len - cached_len queries at q_offset
    # cached_len over Sk = comp_len keys (the second wave reuses its
    # whole shared prefix, which the slice checks below).
    admissions = [(len(p), 0) for p in prompts] + \
        [(len(p), n) for p, (_, n, _) in zip(wave2, shared)]
    path_shapes = []
    for S, cached in admissions:
        _, comp = paged.admission_len(S, cached, bs, n_blocks)
        if (comp - cached, comp, cached) not in path_shapes:
            path_shapes.append((comp - cached, comp, cached))
    def work(sh):
        return causal_pairs(sh[0], sh[1], sh[2], None)
    largest = max(path_shapes, key=work)
    # The planted causal-edge fault goes on the largest prefix-hit case.
    fault_shape = max((sh for sh in path_shapes if sh[2] > 0), key=work)
    # Decode positions of the slice's last wave-1 tick.
    dec_pos = [n + ticks - 1 for n in lengths]

    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device=dev)
    path_pre = [
        prefill_case(fa, attn, F, torch, dev, flush,
                     f"gemma2b_sq{Sq}_sk{Sk}_off{off}", Sq, Sk, 8, 1, 256,
                     q_offset=off, fault=(Sq, Sk, off) == fault_shape)
        for Sq, Sk, off in path_shapes]
    pre = path_pre + [
        prefill_case(fa, attn, F, torch, dev, flush, "llama3_8b_s16",
                     16, 80, 32, 8, 128, q_offset=64),
        prefill_case(fa, attn, F, torch, dev, flush, "llama3_8b_s512",
                     512, 768, 32, 8, 128, q_offset=256),
        prefill_case(fa, attn, F, torch, dev, flush, "llama3_8b_s2048",
                     2048, 4096, 32, 8, 128, q_offset=2048),
        prefill_case(fa, attn, F, torch, dev, flush,
                     "gemma2_window_softcap", 512, 1024, 8, 4, 256,
                     q_offset=512, window=256, softcap=50.0),
    ]
    dec = [
        decode_case(fa, torch, np, dev, flush, "gemma2b_b8", dec_pos,
                    8, 1, 256, bs=bs, nb=n_blocks, fault=True),
        decode_case(fa, torch, np, dev, flush, "llama3_8b_b8", dec_pos,
                    32, 8, 128, bs=bs, nb=n_blocks),
        decode_case(fa, torch, np, dev, flush, "gemma2_window_softcap",
                    dec_pos, 8, 4, 256, window=1024, softcap=50.0, bs=bs,
                    nb=n_blocks),
    ]
    del flush

    # -- slice: Gemma-2B at full width over the paged pool -------------
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

    fa.flash_attention.launches = 0
    fa.paged_flash_decode.launches = 0
    run = serve(paged, cfg, params, prompts, wave2, "auto", ticks,
                profile=4)
    launches = {"flash_attention": fa.flash_attention.launches,
                "paged_flash_decode": fa.paged_flash_decode.launches}
    ref = serve(paged, cfg, params, prompts, wave2, "reference", ticks,
                profile=4)
    if fa.flash_attention.launches != launches["flash_attention"] or \
            fa.paged_flash_decode.launches != \
            launches["paged_flash_decode"]:
        raise AssertionError("the reference server launched a kernel")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
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
          "card": card})

    # The kernels line times each kernel at its largest main-path case.
    main_pre = path_pre[path_shapes.index(largest)]
    main_dec = dec[0]
    kernels = [
        {"name": "flash_attention", "route": "cuda",
         "source": "tpushare_torch/csrc/flash_prefill.cu",
         "replaces": "tpushare/ops/flash_attention.py:105",
         "also_replaces": "tpushare/ops/flash_attention.py:180",
         "launches": launches["flash_attention"],
         "max_abs_err": max(r["max_abs_err"] for r in pre),
         "ulp_ratio": max(r["ulp_ratio"] for r in pre),
         "ms": main_pre["ms"], "plain_ms": main_pre["plain_ms"],
         "bound_ms": main_pre["bound_ms"], "bound_by": main_pre["bound_by"],
         "library_ms": main_pre["library_ms"],
         "case": main_pre["case"]},
        {"name": "paged_flash_decode", "route": "cuda",
         "source": "tpushare_torch/csrc/paged_decode.cu",
         "replaces": "tpushare/ops/flash_attention.py:659",
         "launches": launches["paged_flash_decode"],
         "max_abs_err": max(r["max_abs_err"] for r in dec),
         "ulp_ratio": max(r["ulp_ratio"] for r in dec),
         "ms": main_dec["ms"], "plain_ms": main_dec["plain_ms"],
         "bound_ms": main_dec["bound_ms"], "bound_by": main_dec["bound_by"],
         "library_ms": None, "case": main_dec["case"]},
    ]
    for k in kernels:
        for key in ("ms", "plain_ms", "bound_ms", "max_abs_err"):
            if not (isinstance(k[key], float) and math.isfinite(k[key])):
                raise AssertionError(f"{k['name']}: {key} = {k[key]}")
    print(card, flush=True)
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
