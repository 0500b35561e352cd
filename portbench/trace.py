"""The traced run: spans around the program's kernel entries, the
profiler over the window, and the reduction of its trace to device
times.

``KernelSpans.install`` replaces each timed entry of the program (by
the function object, wherever a ``tpushare_torch`` module binds it) by
a wrapper that, while recording, notes the call's arguments for
``flops.py`` and runs it inside a ``torch.profiler.record_function``
span named ``portbench.<family>``. The families are the entries, not
the kernels they launch: a later change that renames or replaces a
kernel under an entry is timed the same way. Small tensors the work
count needs (a paged call's block table and positions) are cloned on
the device before the span opens, once per forward; an expert call
keeps the router's choices (``ROUTING``'s result) made just before it,
so that its work counts only the rows the router gave each expert.

``start_profiler`` records CUDA activity and these host spans only: the
program's own operators are not recorded, so the traced host runs near
its untraced pace.

``reduce_trace`` reads the profiler's raw events: each kernel is
charged to the innermost ``portbench.*`` span open where the host
launched it. ``busy_s`` is the union of every device activity inside the
window; the idle gaps are charged to the innermost host span that was
open when each gap began.
"""

from __future__ import annotations

import bisect
import collections
import functools
import sys
import threading
from typing import Dict, List, Optional, Tuple

import torch

#: (module, attribute, family) of every timed entry.
ENTRIES = (
    ("tpushare_torch.ops.flash_attention", "flash_attention", "prefill_attn"),
    ("tpushare_torch.ops.flash_attention", "paged_flash_verify",
     "prefill_attn"),
    ("tpushare_torch.ops.flash_attention", "paged_flash_decode",
     "paged_decode"),
    ("tpushare_torch.ops.q8_expert", "q8_expert_ffn", "q8_expert"),
)
#: (module, attribute) of the router's top-k pick: its indices [..., K].
ROUTING = ("tpushare_torch.models.moe", "top_k_lower_index")
SPAN_PREFIX = "portbench."
#: Host stages of the engine's tick, spanned for the idle-gap breakdown.
ENGINE_STAGES = ("_try_admit", "_finalize_pending", "_schedule_and_dispatch",
                 "_advance_one_admission", "_tick")


class KernelSpans:
    """Wraps the timed entries; ``calls`` holds one (family, entry,
    argument record) per call made while ``recording`` is set."""

    def __init__(self):
        self.recording = False
        self.calls: List[Tuple[str, str, dict]] = []
        self._last = None
        self._route = None
        self._patched: List[Tuple[object, str, object]] = []
        self._lock = threading.Lock()

    def _snapshots(self, table: torch.Tensor, pos: torch.Tensor):
        """Device copies of a paged call's table and positions as they
        are now. The servers make a new positions tensor for every
        forward and change the table only between forwards, so the
        layers of one forward share one copy."""
        if self._last is None or self._last[0] is not pos:
            self._last = (pos, table.clone(), pos.clone())
        return self._last[1], self._last[2]

    def _record(self, entry: str, args, kw) -> dict:
        if entry == "flash_attention":
            q, k = args[0], args[1]
            return {"q": tuple(q.shape), "k": tuple(k.shape),
                    "q_offset": int(kw.get("q_offset", 0)),
                    "window": kw.get("window"), "elt": q.element_size()}
        if entry in ("paged_flash_decode", "paged_flash_verify"):
            q, pool_k, table, pos = args[0], args[1], args[3], args[4]
            table, pos = self._snapshots(table, pos)
            return {"q": tuple(q.shape), "bs": int(pool_k.shape[1]),
                    "kv_heads": int(pool_k.shape[2]),
                    "q_elt": q.element_size(),
                    "kv_elt": pool_k.element_size(),
                    "table": table, "pos": pos}
        x, wgq = args[0], args[1]
        top_i, self._route = self._route, None
        rows = int(x.shape[-2]) if x.ndim == 2 else None
        if top_i is None or rows is None or \
                top_i.numel() != rows * top_i.shape[-1]:
            top_i = None            # not one routed token block
        return {"rows": rows, "top_i": top_i, "d": int(wgq.shape[1]),
                "ffn": int(wgq.shape[2]), "elt": x.element_size()}

    def _wrap(self, fn, entry: str, family: str):
        span = SPAN_PREFIX + family

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not self.recording:
                return fn(*args, **kw)
            rec = self._record(entry, args, kw)
            with self._lock:
                self.calls.append((family, entry, rec))
            with torch.profiler.record_function(span):
                return fn(*args, **kw)
        wrapper.__portbench_original__ = fn
        return wrapper

    def _wrap_routing(self, fn):
        @functools.wraps(fn)
        def wrapper(*args, **kw):
            out = fn(*args, **kw)
            if self.recording:
                self._route = out[1]
            return out
        wrapper.__portbench_original__ = fn
        return wrapper

    def install(self) -> None:
        """Replace every binding of each entry, and of the router's pick,
        in the loaded ``tpushare_torch`` modules."""
        import importlib
        hooks = [(m, a, lambda fn, a=a, f=f: self._wrap(fn, a, f))
                 for m, a, f in ENTRIES]
        hooks.append((*ROUTING, self._wrap_routing))
        for mod_name, attr, make in hooks:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            wrapped = make(fn)
            for name, m in list(sys.modules.items()):
                if m is None or name.split(".")[0] != "tpushare_torch":
                    continue
                for k, v in list(vars(m).items()):
                    if v is fn:
                        self._patched.append((m, k, v))
                        setattr(m, k, wrapped)

    def uninstall(self) -> None:
        for m, k, v in reversed(self._patched):
            setattr(m, k, v)
        self._patched.clear()


def span_engine_stages(engine) -> None:
    """Wrap the engine's tick stages in host spans (instance attributes,
    so nothing outside this engine changes)."""
    for stage in ENGINE_STAGES:
        fn = getattr(engine, stage, None)
        if fn is None:
            continue

        def wrapped(*a, _fn=fn, _name="engine." + stage.strip("_"), **kw):
            with torch.profiler.record_function(_name):
                return _fn(*a, **kw)
        setattr(engine, stage, wrapped)


def start_profiler():
    """A started ``torch.profiler`` over CUDA activity and host spans.
    Its host callbacks are limited to the user scope (the
    ``record_function`` spans) where this PyTorch lets the scope be
    chosen; ``prof.user_scope_only`` says whether it did."""
    from torch.autograd import profiler as autograd_profiler
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts, record_shapes=False,
                   profile_memory=False, with_stack=False)
    enable = getattr(autograd_profiler, "_enable_profiler", None)
    scope = getattr(torch._C._profiler, "RecordScope", None)
    used = []

    def user_scope_only(config, activities, scopes=None):
        used.append(True)
        return enable(config, activities, {scope.USER_SCOPE})

    if enable is not None and scope is not None:
        autograd_profiler._enable_profiler = user_scope_only
    try:
        prof.start()
    finally:
        if enable is not None:
            autograd_profiler._enable_profiler = enable
    prof.user_scope_only = bool(used)
    return prof


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


class Segments:
    """The nested spans of one host thread as disjoint segments, each
    named by the innermost span open over it."""

    def __init__(self, spans: List[Tuple[int, int, str]]):
        self.starts: List[int] = []
        self.ends: List[int] = []
        self.names: List[str] = []
        stack: List[Tuple[int, int, str]] = []
        cur = None
        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            while stack and stack[-1][1] <= a:
                top = stack.pop()
                self._emit(cur, top[1], top[2])
                cur = max(cur, top[1])
            if stack:
                self._emit(cur, a, stack[-1][2])
            stack.append((a, b, name))
            cur = a
        while stack:
            top = stack.pop()
            self._emit(cur, top[1], top[2])
            cur = max(cur, top[1])

    def _emit(self, a, b, name) -> None:
        if a is not None and b > a:
            self.starts.append(a)
            self.ends.append(b)
            self.names.append(name)

    def at(self, t: int) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.ends[i]:
            return self.names[i]
        return None


#: Host spans this module opens (``portbench.*`` and ``engine.*``).
HOST_SPANS = (SPAN_PREFIX, "engine.")


def end_ns(e) -> int:
    end = getattr(e, "end_ns", None)
    return end() if end is not None else e.start_ns() + e.duration_ns()


def reduce_trace(prof, t0_ns: int, t1_ns: int) -> dict:
    """Device busy time, kernel time per span family, the busiest
    device operations and the longest idle gaps by host span, from the
    profiler's raw events in [t0_ns, t1_ns] (the profiler's clock).

    A kernel is charged through the host event that launched it: the
    CPU op or span whose correlation id is the kernel's linked one (the
    innermost one open at the launch), else the runtime call of the
    kernel's own correlation id; then to the innermost ``portbench.*``
    span open at that event's start on its thread."""
    events = prof.profiler.kineto_results.events()
    ops: Dict[int, Tuple[int, int]] = {}
    runtime: Dict[int, Tuple[int, int]] = {}
    spans_by_tid: Dict[int, List[Tuple[int, int, str]]] = \
        collections.defaultdict(list)
    host_by_tid: Dict[int, List[Tuple[int, int, str]]] = \
        collections.defaultdict(list)
    device: List[Tuple[int, int, str, int, int]] = []
    cpu = torch.autograd.DeviceType.CPU
    for e in events:
        name = e.name()
        if e.device_type() != cpu:
            if not name.startswith(HOST_SPANS):   # not a span's mirror
                device.append((e.start_ns(), end_ns(e), name,
                               e.correlation_id(),
                               e.linked_correlation_id()))
            continue
        at = (e.start_thread_id(), e.start_ns())
        if name.startswith("cu"):
            # A CUDA runtime or driver call: a launch carries the
            # correlation id of its kernel.
            runtime[e.correlation_id()] = at
            continue
        ops[e.correlation_id()] = at
        if name.startswith(HOST_SPANS):
            rec = (e.start_ns(), end_ns(e), name)
            if name.startswith(SPAN_PREFIX):
                spans_by_tid[at[0]].append(rec)
            host_by_tid[at[0]].append(rec)
    span_segs = {t: Segments(v) for t, v in spans_by_tid.items()}

    family_s: Dict[str, float] = collections.defaultdict(float)
    by_name: Dict[str, float] = collections.defaultdict(float)
    busy: List[Tuple[int, int]] = []
    unmatched = 0
    for a, b, name, corr, linked in device:
        a, b = max(a, t0_ns), min(b, t1_ns)
        if b <= a:
            continue
        busy.append((a, b))
        by_name[name] += (b - a) * 1e-9
        launch = ops.get(linked) if linked else None
        launch = launch or runtime.get(corr)
        if launch is None:
            unmatched += 1
            continue
        tid, ts = launch
        if tid in span_segs:
            fam = span_segs[tid].at(ts)
            if fam is not None:
                family_s[fam[len(SPAN_PREFIX):]] += (b - a) * 1e-9
    merged = _merge(busy)
    busy_s = sum(b - a for a, b in merged) * 1e-9

    # Idle gaps, charged to the innermost host span open at their start
    # on the engine's thread (the one with the most engine spans).
    engine_tids = collections.Counter(
        {t: sum(1 for r in v if not r[2].startswith(SPAN_PREFIX))
         for t, v in host_by_tid.items()})
    main_tid = engine_tids.most_common(1)[0][0] if engine_tids else None
    host = Segments(host_by_tid.get(main_tid, []))
    gaps: Dict[str, float] = collections.defaultdict(float)
    edges = [t0_ns] + [x for ab in merged for x in ab] + [t1_ns]
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        if b <= a:
            continue
        gaps[host.at(a) or "host: outside any span"] += (b - a) * 1e-9
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy_s, "window_s": (t1_ns - t0_ns) * 1e-9,
            "family_s": dict(family_s),
            "device_ops": [[n[:120], s] for n, s in top],
            "idle_gaps": [[n[:120], s] for n, s in top_gaps],
            "kernels": len(device), "unmatched_kernels": unmatched}
