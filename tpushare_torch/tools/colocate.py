"""BASELINE.md's co-location run on one card: two BERT-base tenant
processes, each under the env the port's Allocate gives its pod.

The port's counterpart of ``bench.py``'s ``plugin_env``,
``tenant_main``, ``_run_streams`` and ``_measure`` (the A-B-A protocol)
and of ``benchmarks/bench_isolation.py``'s HOG/STEADY pair. Run from the
repository root:

    python -m tpushare_torch.tools.colocate                 # on the card
    python -m tpushare_torch.tools.colocate --device cpu --tiny --seconds 0.5

Without ``--device cpu`` it needs a CUDA card and exits 2, naming it,
where there is none. Prints one JSON line per run, then the record.

- Allocate: the node is NVML's topology (``--device cpu``: a one-card
  fake of 128 MiB, granted in MiB), the Allocator its single-card fast
  path. Grants: the whole card solo, 16 units for each co-located
  tenant, 8 for the HOG and 16 for the STEADY tenant.
- A tenant (a new interpreter, never a fork) calls
  ``apply_tenant_limits()`` before any CUDA use, pins a disjoint CPU
  slice, builds BERT (bf16 BERT-base at batch 8 x seq 128; ``--tiny``:
  the f32 tiny config at 2 x 32) from seed 0, and meets the parent's
  barrier (READY / GO / WARM / T0). Its *serve* window makes one blocked
  forward per call; its *sat* window runs K = 16 chained forwards per
  call, each one's tokens bumped on the device by the previous pooled
  sum, one sync per chain. It reports tokens/s for both windows, its
  guard's breaches, its pooled output for the seed's tokens (digest),
  that output's distance from the f32 forward through ``mha_reference``,
  its ``memory_reserved`` and NVML's per-process bytes, and ``mfu_pct``
  against the card's dense bf16 peak (``utils/profiling.py``; null on a
  card its tables do not hold).
- A-B-A: solo, two tenants, solo again. ``colocated_pct`` = 100 x
  min(co serve) / mean(solo serve); the record is refused (``credible``
  false, with reasons) when the solo windows differ by more than 5% or
  the ratio exceeds 100%.
- Isolation: a STEADY tenant serves through 10 windows while a HOG, from
  its fourth, walks 256 MiB allocations (a quarter unit) to 1.5 x its
  grant; it must stop (``torch.OutOfMemoryError`` from the allocator's
  fraction, or ``SoftHbmOom`` from the guard) by its grant plus one
  step. A planted fault, the HOG with ``TPUSHARE_HBM_ENFORCE=off`` and
  ``CTPU_DISABLE=true``, must walk past it.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import select
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from tpushare_torch.deviceplugin import pb
from tpushare_torch.models import bert
from tpushare_torch.plugin import const
from tpushare_torch.plugin.allocate import Allocator
from tpushare_torch.plugin.backend import FakeBackend
from tpushare_torch.plugin.devices import expand_devices
from tpushare_torch.plugin.nvmldisc import (Nvml, NvmlBackend, NvmlError,
                                            load_library)
from tpushare_torch.utils import profiling
from tpushare_torch.utils.tenant import (SoftHbmOom, apply_tenant_limits,
                                         get_enforcing_guard, read_tenant_env,
                                         tenant_device)

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULT_TAG = "COLOCATE_RESULT "
CHAIN_K = 16
CO_UNITS, HOG_UNITS, STEADY_UNITS = 16, 8, 16
INIT_TIMEOUT_S = 300.0
ISO_WINDOWS, HOG_AT_WINDOW = 10, 3
HOG_OVERSHOOT = 1.5
#: max |bf16 pooled - f32 pooled| over BERT-base's pooled output (tanh,
#: in (-1, 1)) at 8 x 128: 12 post-norm layers of bf16 rounding (2^-9
#: relative per op) against the f32 forward of the same weights. The
#: same forward on the host (PyTorch's bf16 CPU products, f32 sums) reads
#: 0.0227; the limit leaves twice that.
POOLED_BF16_TOL = 5e-2
FAKE_CARD_GIB = 0.125


# -- the node and its Allocate --------------------------------------------

class _NoPendingPods:
    """No extender-assumed pod: Allocate takes the single-card fast
    path, as on a one-card node."""

    def get_candidate_pods(self):
        return []


def node(device: str):
    """(topology, memory unit) of the node: NVML's on the card; on the
    host a one-card fake of 128 MiB granted in MiB."""
    if device == "cpu":
        return (FakeBackend(chips=1, hbm_gib=FAKE_CARD_GIB,
                            generation="h100").probe(), const.MIB)
    return NvmlBackend().probe(), const.GIB


def single_card_allocator(topo, memory_unit, podmgr=None):
    """(Allocator, DeviceMap) over ``topo``; with no ``podmgr`` there is
    no candidate pod and a one-card node takes the fast path."""
    devmap = expand_devices(topo, memory_unit)
    return Allocator(devmap, topo, podmgr or _NoPendingPods(),
                     kube=None), devmap


def allocate(alloc, devmap, units: int):
    """One pod of one container requesting ``units`` fake devices,
    through ``Allocator.allocate`` on the kubelet's messages; returns the
    container's response."""
    ids = [d.ID for d in devmap.devices[:units]]
    resp = alloc.allocate(pb.AllocateRequest(container_requests=[
        pb.ContainerAllocateRequest(devicesIDs=ids)]))
    return resp.container_responses[0]


def plugin_env(topo, memory_unit, units: Optional[int] = None) -> dict:
    """The env Allocate injects for a ``units`` pod (default: the whole
    card); raises on the poisoned env."""
    alloc, devmap = single_card_allocator(topo, memory_unit)
    units = units or devmap.units_per_chip[topo.chips[0].index]
    envs = dict(allocate(alloc, devmap, units).envs)
    if envs.get(const.ENV_NVIDIA_VISIBLE_DEVICES, "").startswith("no-"):
        raise RuntimeError(f"allocation poisoned: {envs}")
    return envs


# -- a tenant process -------------------------------------------------------

def _pin_cpus(stream: int) -> List[int]:
    """A disjoint slice of the host's cores per stream, as a kubelet
    cpuset gives each pod: the contended resource is the card."""
    cores = sorted(os.sched_getaffinity(0))
    k = min(4, len(cores) // 2)
    if k < 1:
        return cores
    mine = cores[stream * k:(stream + 1) * k] or cores[:k]
    os.sched_setaffinity(0, mine)
    torch.set_num_threads(len(mine))
    return mine


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _barrier(warm) -> float:
    """READY -> GO -> re-warm -> WARM -> the parent's T0."""
    print("READY", flush=True)
    sys.stdin.readline()                              # GO
    warm()
    print("WARM", flush=True)
    anchor = sys.stdin.readline().split()             # T0 <t0>
    return float(anchor[1]) if len(anchor) > 1 else time.time() + 0.2


def _window(fn, start: float, seconds: float):
    """Blocked calls of fn inside [start, start + seconds): (calls,
    measured seconds)."""
    while time.time() < start:
        time.sleep(min(0.01, max(0.0, start - time.time())))
    deadline = start + seconds
    calls, w0 = 0, time.perf_counter()
    while time.time() < deadline:
        fn()
        calls += 1
    return calls, time.perf_counter() - w0


def _nvml_processes(card: int):
    """NVML's (pid, bytes) per compute process on ``card`` (its pids are
    the host's PID namespace, not necessarily this process's)."""
    try:
        with Nvml(load_library()) as nv:
            return nv.processes(nv.handle(card))
    except (OSError, NvmlError) as e:
        return f"not read: {e}"


def _memory(dev, spec) -> dict:
    if dev.type != "cuda":
        return {"memory_reserved": None, "max_memory_reserved": None,
                "nvml_processes": None}
    return {"memory_reserved": torch.cuda.memory_reserved(dev),
            "max_memory_reserved": torch.cuda.max_memory_reserved(dev),
            "nvml_processes": _nvml_processes(
                spec.chips[0] if spec.chips else 0),
            "pid": os.getpid()}


def _device_idle(fn, n: int) -> dict:
    """Device busy ms per call and the idle share of ``n`` calls' wall
    time (torch.profiler, CUDA activity only)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return {"calls": n, "wall_ms_per_call": wall_ms / n,
            "device_ms_per_call": busy / n, "idle_share": 1 - busy / wall_ms}


def _bert(args, dev):
    """(cfg, params, seed tokens, batch, seq, serve) of the tenant's
    encoder; ``serve()`` is one blocked forward of the seed tokens."""
    cfg = bert.tiny() if args.tiny else bert.bert_base()
    batch, seq = (2, 32) if args.tiny else (8, 128)
    params = bert.init_params(torch.Generator(device=dev).manual_seed(0),
                              cfg, device=dev)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq)), device=dev)

    @torch.inference_mode()
    def serve():
        bert.forward(params, tokens, cfg)["pooled"]
        _sync(dev)

    return cfg, params, tokens, batch, seq, serve


def tenant_main(args) -> None:
    """One co-located pod: consume the injected env as a real tenant
    does, then the serve and sat windows around the parent's T0."""
    cores = _pin_cpus(args.stream)
    spec = apply_tenant_limits()              # before any CUDA use
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = tenant_device() if args.device == "cuda" else torch.device("cpu")
    cfg, params, tokens, batch, seq, serve = _bert(args, dev)

    @torch.inference_mode()
    def sat():
        t = tokens
        for _ in range(CHAIN_K):
            pooled = bert.forward(params, t, cfg)["pooled"]
            bump = pooled.float().sum().to(torch.int32) & 1   # data dependency
            t = (t + bump) % cfg.vocab_size
        _sync(dev)

    serve()
    sat()
    t0 = _barrier(lambda: (serve(), sat()))
    gap = args.seconds / 3
    serve_calls, serve_s = _window(serve, t0, args.seconds)
    sat_calls, sat_s = _window(sat, t0 + args.seconds + gap, args.seconds)
    guard = get_enforcing_guard()
    memory = _memory(dev, spec)          # the serving footprint, before
    with torch.inference_mode():         # the f32 twin's weights exist
        pooled = bert.forward(params, tokens, cfg)["pooled"].float()
        cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
        p32 = {g: {k: v.float() for k, v in leaves.items()}
               for g, leaves in params.items()}
        want = bert.forward(p32, tokens, cfg32,
                            attn_impl="reference")["pooled"]
    host = pooled.cpu().contiguous()
    result = {
        "stream": args.stream, "cores": cores,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "batch": batch, "seq": seq, "chain_k": CHAIN_K,
        "serve_calls": serve_calls, "sat_calls": sat_calls,
        "serve_tokens_per_sec": serve_calls * batch * seq / serve_s,
        "sat_tokens_per_sec": sat_calls * CHAIN_K * batch * seq / sat_s,
        "hbm_breaches": guard.breaches if guard else 0,
        "hbm_limit_bytes": spec.hbm_limit_bytes,
        "pooled_sha256": hashlib.sha256(host.numpy().tobytes()).hexdigest(),
        "pooled_finite": bool(torch.isfinite(host).all()),
        "pooled_vs_f32_max_abs": (pooled - want).abs().max().item(),
        "cuda_visible_devices": os.environ.get("CUDA_VISIBLE_DEVICES"),
        **memory,
    }
    if dev.type == "cuda" and sat_calls:
        step_s = sat_s / (sat_calls * CHAIN_K)
        m = profiling.mfu(bert.flops_per_forward(cfg, batch, seq), step_s,
                          profiling.card_key(dev))
        result["mfu_pct"] = None if m is None else 100 * m
        result["profile"] = _device_idle(serve, 50)
    print(RESULT_TAG + json.dumps(result), flush=True)


def steady_main(args) -> None:
    """The STEADY tenant: serve windows the whole time its neighbour
    walks past its grant; each window's start (wall clock) and rate."""
    _pin_cpus(args.stream)
    spec = apply_tenant_limits()
    dev = tenant_device() if args.device == "cuda" else torch.device("cpu")
    _, _, _, batch, seq, serve = _bert(args, dev)
    serve()
    _barrier(serve)
    win = args.seconds / 6
    windows = []
    for _ in range(ISO_WINDOWS):
        w0, c0 = time.time(), time.perf_counter()
        calls = 0
        while time.time() < w0 + win:
            serve()
            calls += 1
        windows.append({"t": w0, "tokens_per_sec":
                        calls * batch * seq / (time.perf_counter() - c0)})
    guard = get_enforcing_guard()
    print(RESULT_TAG + json.dumps({
        "windows": windows, "hbm_breaches": guard.breaches if guard else 0,
        **_memory(dev, spec)}), flush=True)


def hog_main(args) -> None:
    """The HOG: walk allocations of a quarter unit past the grant to
    1.5 x it; report where it stopped and why. On the host nothing caps
    an allocation and nothing reports reserved bytes: the guard reads
    the walk's own bytes, and each step waits until the guard has read
    it twice (the stop lands in that wait)."""
    _pin_cpus(args.stream)
    grant = read_tenant_env()
    limit = grant.hbm_limit_bytes
    if not (limit and grant.container_units):
        raise SystemExit("hog: no memory grant in its env")
    step = limit // grant.container_units // 4          # a quarter unit
    held: List = []
    polls = [0]
    cpu = args.device == "cpu"

    def walked():
        polls[0] += 1
        return len(held) * step

    apply_tenant_limits(used_bytes_fn=walked if cpu else None)
    dev = torch.device("cpu") if cpu else tenant_device()
    target = int(HOG_OVERSHOOT * limit)
    print("READY", flush=True)
    sys.stdin.readline()                              # GO
    t_go = time.time()
    stopped, err = None, ""
    try:
        while len(held) * step < target:
            a = torch.ones(step // 4, dtype=torch.float32, device=dev)
            _sync(dev)
            held.append(a)
            if cpu and get_enforcing_guard() is not None:
                seen = polls[0]
                while polls[0] < seen + 2:
                    time.sleep(0.005)
    except torch.OutOfMemoryError as e:
        stopped, err = "OutOfMemoryError", str(e).splitlines()[0][:200]
    except SoftHbmOom as e:
        stopped, err = "SoftHbmOom", str(e)[:200]
    t_stop = time.time()
    nbytes = len(held) * step
    reserved = torch.cuda.memory_reserved(dev) if not cpu else nbytes
    del held
    print(RESULT_TAG + json.dumps({
        "stopped_by": stopped, "error": err, "held_bytes": nbytes,
        "memory_reserved_at_stop": reserved, "limit_bytes": limit,
        "step_bytes": step, "target_bytes": target,
        "t_go": t_go, "t_stop": t_stop,
        "within_grant": nbytes <= limit + step}), flush=True)


# -- the parent ---------------------------------------------------------------

def _readline(p: subprocess.Popen, deadline: float) -> str:
    """One stdout line of ``p``, or raise once ``deadline`` passes."""
    while True:
        remaining = deadline - time.time()
        if remaining <= 0:
            raise RuntimeError("tenant deadline exceeded")
        ready, _, _ = select.select([p.stdout], [], [], min(remaining, 5.0))
        if ready or p.poll() is not None:
            return p.stdout.readline()


def _spawn(role: str, env: dict, args, stream: int) -> subprocess.Popen:
    child = dict(os.environ, **env)
    child["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    cmd = [sys.executable, "-m", "tpushare_torch.tools.colocate", f"--{role}",
           "--device", args.device, "--seconds", str(args.seconds),
           "--stream", str(stream)]
    if args.tiny:
        cmd.append("--tiny")
    return subprocess.Popen(cmd, env=child, stdin=subprocess.PIPE,
                            stdout=subprocess.PIPE, text=True, cwd=REPO)


def _send(p: subprocess.Popen, line: str) -> None:
    p.stdin.write(line + "\n")
    p.stdin.flush()


def _expect(p: subprocess.Popen, word: str, deadline: float) -> None:
    line = _readline(p, deadline)
    if not line.startswith(word):
        raise RuntimeError(f"tenant died before {word}: {line!r}")


def _result(p: subprocess.Popen, timeout: float) -> dict:
    out, _ = p.communicate(timeout=timeout)
    if p.returncode != 0:
        raise RuntimeError(f"tenant exited rc={p.returncode}: {out[-400:]!r}")
    lines = [l for l in out.splitlines() if l.startswith(RESULT_TAG)]
    if not lines:
        raise RuntimeError(f"tenant emitted no result: {out[-400:]!r}")
    return json.loads(lines[-1][len(RESULT_TAG):])


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait(30)


def run_streams(env: dict, n: int, args) -> list:
    """n tenant processes under one pod env; barriered past warm-up so
    their windows overlap; their results."""
    deadline = time.time() + INIT_TIMEOUT_S
    procs = [_spawn("tenant", env, args, i) for i in range(n)]
    try:
        for p in procs:
            _expect(p, "READY", deadline)
        for p in procs:
            _send(p, "GO")
        for p in procs:
            _expect(p, "WARM", time.time() + 120)
        t0 = time.time() + 0.5                 # shared wall-clock anchor
        for p in procs:
            _send(p, f"T0 {t0}")
        return [_result(p, INIT_TIMEOUT_S) for p in procs]
    finally:
        _kill(procs)


def measure(solo_env: dict, co_env: dict, args, log=print) -> dict:
    """A-B-A: solo window, two co-located tenants, solo again, in one
    run; the record with ``colocated_pct``, the solo variance and
    ``credible``."""
    a1 = run_streams(solo_env, 1, args)[0]
    log(json.dumps({"window": "solo_a1", **a1}))
    co = run_streams(co_env, 2, args)
    for r in co:
        log(json.dumps({"window": "colocated", **r}))
    a2 = run_streams(solo_env, 1, args)[0]
    log(json.dumps({"window": "solo_a2", **a2}))
    s1, s2 = a1["serve_tokens_per_sec"], a2["serve_tokens_per_sec"]
    solo = (s1 + s2) / 2
    variance_pct = 100 * abs(s1 - s2) / solo
    value = 100 * min(r["serve_tokens_per_sec"] for r in co) / solo
    solo_sat = (a1["sat_tokens_per_sec"] + a2["sat_tokens_per_sec"]) / 2
    reasons = []
    if variance_pct > 5.0:
        reasons.append(f"solo A1/A2 variance {variance_pct:.1f}% > 5% "
                       f"(baseline unstable)")
    if value > 100.0:
        reasons.append(f"co-located/solo {value:.1f}% > 100% is physically "
                       f"impossible against a saturated solo baseline")
    return {"colocated_pct": value, "solo_variance_pct": variance_pct,
            "credible": not reasons, "refusal_reasons": reasons,
            "sat_colocated_pct": [100 * r["sat_tokens_per_sec"] / solo_sat
                                  for r in co],
            "windows": {"solo_a1": a1, "colocated": co, "solo_a2": a2}}


def isolation(hog_env: dict, steady_env: dict, args) -> dict:
    """STEADY serves while the HOG walks past its grant; the record
    with the HOG's stop and STEADY's windows before, during and after
    it."""
    deadline = time.time() + INIT_TIMEOUT_S
    steady = _spawn("steady", steady_env, args, 0)
    hog = _spawn("hog", hog_env, args, 1)
    try:
        for p in (steady, hog):
            _expect(p, "READY", deadline)
        _send(steady, "GO")
        _expect(steady, "WARM", time.time() + 120)
        _send(steady, f"T0 {time.time()}")
        time.sleep(HOG_AT_WINDOW * args.seconds / 6)
        _send(hog, "GO")
        h = _result(hog, INIT_TIMEOUT_S)
        s = _result(steady, INIT_TIMEOUT_S)
    finally:
        _kill((steady, hog))
    phases: Dict[str, list] = {"before": [], "during": [], "after": []}
    win = args.seconds / 6
    for w in s["windows"]:
        key = ("before" if w["t"] + win <= h["t_go"] else
               "after" if w["t"] >= h["t_stop"] else "during")
        phases[key].append(w["tokens_per_sec"])
    return {"hog": h, "steady": s,
            "steady_tokens_per_sec": {k: (sum(v) / len(v) if v else None)
                                      for k, v in phases.items()}}


def planted_hog(hog_env: dict, args) -> dict:
    """The HOG alone with enforcement off and isolation disabled: it
    must walk past its grant (the isolation gate can fail)."""
    env = dict(hog_env, TPUSHARE_HBM_ENFORCE="off", CTPU_DISABLE="true")
    p = _spawn("hog", env, args, 1)
    try:
        _expect(p, "READY", time.time() + INIT_TIMEOUT_S)
        _send(p, "GO")
        return _result(p, INIT_TIMEOUT_S)
    finally:
        _kill((p,))


def run(args, log=print) -> dict:
    """The whole protocol: Allocate's envs, A-B-A, isolation, the planted
    fault."""
    topo, unit = node(args.device)
    envs = {name: plugin_env(topo, unit, units) for name, units in (
        ("solo", None), ("co", CO_UNITS), ("hog", HOG_UNITS),
        ("steady", STEADY_UNITS))}
    record = {"memory_unit": unit, "envs": envs}
    record["colocate"] = measure(envs["solo"], envs["co"], args, log)
    record["isolation"] = isolation(envs["hog"], envs["steady"], args)
    log(json.dumps({"isolation": record["isolation"]}))
    record["planted"] = planted_hog(envs["hog"], args)
    log(json.dumps({"planted": record["planted"]}))
    return record


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true",
                    help="BERT's tiny f32 config at 2 x 32 (CPU runs)")
    ap.add_argument("--seconds", type=float, default=6.0,
                    help="each measured window")
    for role in ("tenant", "steady", "hog"):
        ap.add_argument(f"--{role}", action="store_true",
                        help=argparse.SUPPRESS)
    ap.add_argument("--stream", type=int, default=0, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.tenant:
        tenant_main(args)
    elif args.steady:
        steady_main(args)
    elif args.hog:
        hog_main(args)
    else:
        if args.device == "cuda" and not torch.cuda.is_available():
            print("colocate: no CUDA card; run on an NVIDIA GPU or pass "
                  "--device cpu", file=sys.stderr)
            return 2
        print(json.dumps(run(args, log=lambda s: print(s, flush=True))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
