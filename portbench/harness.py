"""The benchmark's core: one cell, one seed, one window.

``resolve`` finds the cell in ``BENCHMARK.json`` and the files it
names by name: ``configs/<config>.json`` (its ``family`` picks
``families/<family>.py``), ``traffic/<traffic>.json``,
``limits/<workload>.json`` and ``metrics/<metric>.py``. ``run_cell``
builds the model from the seed, the engine (the port's
``ServeEngine``: paged KV, prefix cache, greedy, overlapped tick), sends
the mix's set-up traffic and warm-up, then drives the closed loop from
one thread for the window, and after it reads the served tokens against
the reference. Each metric's reader computes its number from the
``Run`` record; a reader that finds nothing returns None.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import os
import queue
import sys
import time
from typing import Any, Dict, List, Optional

import torch

from portbench import check, flops, loadgen, trace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PB = os.path.join(ROOT, "portbench")
#: Top-level module names that may not be loaded in a run's process.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpushare")
BLOCK_SIZE = 16
#: The start's burst may take this long before the window opens
#: regardless, and after the window the loop runs on until every request
#: sent inside it has its first token, for at most DRAIN_S.
LEAD_S = 200.0
DRAIN_S = 150.0
#: A traced run profiles the window's last TRACE_S seconds (at most half
#: of it): reading a whole window's trace would take the run past its
#: time limit. Its counters and MFU come from the untraced part before.
TRACE_S = 20.0


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    workload: dict
    conf: dict
    mix: dict
    limits: dict
    family: Any
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return workload in metric.get("workloads", [workload])


def resolve(workload: str, bench: Optional[dict] = None,
            root: str = ROOT) -> Cell:
    """The cell named ``workload`` and the files it is made of."""
    bench = bench or load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; the benchmark "
                         f"has {sorted(cells)}")
    w = cells[workload]
    pb = os.path.join(root, "portbench")
    conf_entry = {c["name"]: c for c in bench["configs"]}[w["config"]]
    conf = load_json(os.path.join(root, conf_entry["file"]))
    mix = load_json(os.path.join(pb, "traffic", w["traffic"] + ".json"))
    limits = load_json(os.path.join(pb, "limits", workload + ".json"))
    family = load_file(os.path.join(pb, "families", conf["family"] + ".py"),
                       "portbench_family_" + conf["family"])
    return Cell(w, conf, mix, limits, family,
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


# -- the run record the metric readers read ---------------------------

@dataclasses.dataclass
class Record:
    """One request as the client saw it."""
    client: int
    round: int
    prompt: List[int]
    max_tokens: int
    t_send: float
    req: Any = None
    cancelled: bool = False     # by the load loop, after the window

    @property
    def failed(self) -> bool:
        """No first token, or an error the loop did not cause."""
        return not self.req.t_tokens or (bool(self.req.error)
                                         and not self.cancelled)

    @property
    def tokens(self) -> List[int]:
        return list(self.req.tokens)

    @property
    def t_tokens(self) -> List[float]:
        return list(self.req.t_tokens)

    @property
    def error(self) -> Optional[str]:
        return self.req.error

    @property
    def cached_prefix(self) -> int:
        return int(self.req.cached_prefix)


@dataclasses.dataclass
class Run:
    conf: dict
    card: str
    t0: float
    t1: float
    records: List[Record]
    stats0: Dict[str, Any]
    stats1: Dict[str, Any]
    setup_s: float
    peaks: Optional[tuple] = None       # (FLOP/s, bytes/s); None off a card
    #: Where a traced run's untraced part ends and its traced part
    #: starts (host clock), and the engine's counters there.
    t_split: Optional[float] = None
    stats_split: Optional[Dict[str, Any]] = None
    trace: Optional[dict] = None
    kernel_work: Optional[Dict[str, float]] = None

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    @property
    def untraced(self) -> tuple:
        """(start, end) of the window's part the profiler was off."""
        return self.t0, self.t_split or self.t1

    def untraced_delta(self, key: str) -> float:
        """``key``'s change in the engine's counters over the untraced
        part."""
        end = self.stats_split if self.t_split else self.stats1
        return float(end.get(key) or 0) - float(self.stats0.get(key) or 0)

    def tokens_between(self, a: float, b: float) -> int:
        return sum(1 for r in self.records for t in r.t_tokens
                   if a <= t < b)

    def sent_in_window(self) -> List[Record]:
        return [r for r in self.records if self.t0 <= r.t_send < self.t1]

    def delta(self, key: str) -> float:
        return float(self.stats1.get(key) or 0) - float(
            self.stats0.get(key) or 0)


def percentile(values: List[float], q: float) -> float:
    """The q-th percentile, linear between order statistics."""
    if not values:
        return math.inf
    v = sorted(values)
    k = (len(v) - 1) * q / 100.0
    lo = int(math.floor(k))
    hi = min(lo + 1, len(v) - 1)
    if math.isinf(v[hi]) or math.isinf(v[lo]):
        return math.inf
    return v[lo] + (v[hi] - v[lo]) * (k - lo)


# -- the engine and its load ------------------------------------------

def request_class(done_q: "queue.Queue"):
    """The engine's request type, stamping every pushed token with the
    host clock and reporting its end to the load loop."""
    from tpushare_torch.cli.serve import _Request

    class TimedRequest(_Request):
        def __init__(self, prompt, max_tokens):
            super().__init__(prompt, max_tokens, None)
            self.t_tokens: List[float] = []
            self._reported = False

        def push(self, tok):
            self.t_tokens.append(time.monotonic())
            super().push(tok)

        def finish(self):
            super().finish()
            if not self._reported:
                self._reported = True
                self.t_done = time.monotonic()
                done_q.put(self)

    return TimedRequest


def pool_blocks(model, conf: dict, device: torch.device) -> int:
    """Blocks of the paged pool: what the card holds after the weights
    and the configuration's reserve for activations."""
    cfg = model.cfg
    per_block = (2 * cfg.n_layers * BLOCK_SIZE * cfg.n_kv_heads
                 * cfg.head_dim * torch.tensor([], dtype=cfg.dtype)
                 .element_size())
    if device.type != "cuda":
        return int(conf["pool_blocks"])
    total = torch.cuda.get_device_properties(device).total_memory
    free = (total - torch.cuda.memory_allocated(device)
            - int(conf["activation_reserve_gib"] * (1 << 30)))
    return int(free // per_block)


def build_engine(model, conf: dict, mix: dict, device: torch.device):
    from tpushare_torch.cli.serve import ServeEngine
    max_ctx = loadgen.max_context(mix)
    engine = ServeEngine(
        model.params, model.cfg, n_slots=int(mix["n_slots"]),
        n_blocks=pool_blocks(model, conf, device), block_size=BLOCK_SIZE,
        max_blocks_per_slot=-(-(max_ctx + 1) // BLOCK_SIZE),
        prefix_cache=True, temperature=0.0,
        prefill_chunk=mix.get("prefill_chunk"), overlap_tick=True,
        max_queue=int(mix["clients"]) + 8, device=device,
        **model.engine_kw)
    engine.start()
    return engine


def send_and_wait(engine, req_cls, done_q, prompts, max_tokens,
                  timeout_s: float) -> List[Any]:
    """Send requests together and wait for all of them."""
    reqs = [req_cls(list(p), int(m)) for p, m in zip(prompts, max_tokens)]
    for r in reqs:
        if not engine.submit(r):
            raise RuntimeError("set-up request refused (queue full)")
    deadline = time.monotonic() + timeout_s
    pending = set(map(id, reqs))
    while pending:
        left = deadline - time.monotonic()
        if left <= 0:
            raise RuntimeError("set-up requests did not finish in time")
        try:
            pending.discard(id(done_q.get(timeout=left)))
        except queue.Empty:
            pass
    bad = [r.error for r in reqs if r.error]
    if bad:
        raise RuntimeError(f"set-up request failed: {bad[0]}")
    return reqs


def warm_up(engine, req_cls, done_q, traffic: loadgen.Traffic,
            seed: int) -> None:
    """The longest, the median and the shortest prompt of the mix, sent
    together (so a later one is admitted while an earlier one decodes),
    each with the shortest output: the largest forward and every kind
    of tick the window drives."""
    mix = traffic.mix
    rng = loadgen.rng_for(seed, 9)
    p = loadgen.quantiles(mix["prompt"], 1)[0]
    lens = [int(mix["prompt"]["max"]), p, int(mix["prompt"]["min"])]
    n_out = max(4, int(mix["output"]["min"]))
    prompts = [traffic.docs[i % traffic.clients]
               + rng.integers(0, traffic.vocab, k).tolist()
               for i, k in enumerate(lens)]
    send_and_wait(engine, req_cls, done_q, prompts, [n_out] * len(lens),
                  600.0)


def closed_loop(engine, req_cls, done_q, traffic: loadgen.Traffic,
                seconds: float, on_open=None, events=()):
    """Drive the mix's closed loop. Every client sends its first request
    at once; the window opens when each of those has its first token
    (the start's burst of admissions is set-up), calling ``on_open``,
    and closes ``seconds`` later. Each (offset, fn) of ``events`` is
    called once, ``offset`` seconds into the window. The loop runs on
    until each request sent inside the window has its first token (or
    an end), then cancels what is left. Returns (records, t0, t1)."""
    nxt = [0] * traffic.clients
    records: List[Record] = []
    outstanding = set()
    due = sorted(events, key=lambda e: e[0])

    def send(c: int) -> None:
        rq = traffic.request(c, nxt[c])
        req = req_cls(rq.prompt, rq.max_tokens)
        rec = Record(c, nxt[c], rq.prompt, rq.max_tokens, time.monotonic(),
                     req)
        req.record = rec
        nxt[c] += 1
        records.append(rec)
        outstanding.add(req)
        if not engine.submit(req):
            req.error = "refused: queue full"
            req.finish()

    def started(recs) -> bool:
        return all(r.req.t_tokens or r.req.done.is_set() for r in recs)

    for c in range(traffic.clients):
        send(c)
    first = list(records)
    t0 = t1 = None
    deadline = time.monotonic() + LEAD_S
    while True:
        now = time.monotonic()
        if t0 is None and (started(first) or now >= deadline):
            if on_open is not None:
                on_open()
            t0 = time.monotonic()
            t1 = t0 + seconds
            deadline = t1 + DRAIN_S
        while t0 is not None and due and now >= t0 + due[0][0]:
            due.pop(0)[1]()
        if t0 is not None and now >= t1 and not due and (started(
                [r for r in records if t0 <= r.t_send < t1])
                or now >= deadline):
            break
        wait = 0.05
        if t0 is not None and due:
            wait = min(wait, t0 + due[0][0] - now)
        try:
            req = done_q.get(timeout=max(0.001, wait))
        except queue.Empty:
            continue
        outstanding.discard(req)
        send(req.record.client)
    for req in list(outstanding):
        req.record.cancelled = True
        req.cancelled = True
    return records, t0, t1


# -- the run ----------------------------------------------------------

def kernel_work(calls, card: str) -> Dict[str, float]:
    """Least seconds of the recorded calls, summed by family. A family
    with a call whose work cannot be counted (an expert call without the
    router's choices) is left out."""
    out: Dict[str, float] = {}
    uncounted = set()
    host: Dict[int, Any] = {}

    def np_of(t):
        got = host.get(id(t))
        if got is None:
            got = host[id(t)] = t.cpu().numpy()
        return got

    for family, entry, rec in calls:
        if entry == "flash_attention":
            f, b = flops.flash_attention_work(rec["q"], rec["k"],
                                              rec["q_offset"], rec["elt"],
                                              rec["window"])
        elif entry in ("paged_flash_decode", "paged_flash_verify"):
            f, b = flops.paged_attention_work(
                np_of(rec["table"]), np_of(rec["pos"]), rec["q"], rec["bs"],
                rec["q_elt"], rec["kv_elt"], rec["kv_heads"])
        elif rec["top_i"] is None:
            uncounted.add(family)
            continue
        else:
            top_i = rec["top_i"]
            f, b = flops.q8_expert_work(
                rec["rows"], top_i.numel(), int(torch.unique(top_i).numel()),
                rec["d"], rec["ffn"], rec["elt"])
        out[family] = out.get(family, 0.0) + flops.least_seconds(f, b, card)
    return {k: v for k, v in out.items() if k not in uncounted}


def free_engine(engine) -> None:
    engine.stop()
    engine.srv = None
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             t_start: float, device: Optional[torch.device] = None,
             log=None, control: bool = False) -> Dict[str, Any]:
    """One run of ``cell``: the result object the benchmark prints, and
    (under ``_run``) the record the readers read. ``control`` (never in
    the benchmark's own runs) adds the control's readings over the same
    sample under ``control``."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    device = device or torch.device("cuda", 0)
    on_card = device.type == "cuda"
    card = torch.cuda.get_device_name(device) if on_card else "cpu"
    if on_card:
        flops.peaks(card)                 # no peaks, no run
    marks = {"start": t_start}

    if on_card:
        from tpushare_torch.ops import _build
        _build.build_all()
    marks["build"] = time.monotonic()
    model = cell.family.Model(cell.conf, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
    marks["weights"] = time.monotonic()
    log(f"portbench: weights made in {marks['weights'] - marks['build']:.2f} s")
    spans = trace.KernelSpans() if traced else None
    if spans is not None:
        spans.install()
    engine = build_engine(model, cell.conf, cell.mix, device)
    if traced:
        trace.span_engine_stages(engine)
        # The profiler's first start initialises it (seconds): pay that
        # in set-up, not inside the window.
        engine._engine_call(lambda: trace.start_profiler().stop(),
                            timeout_s=300.0)
    marks["engine"] = time.monotonic()
    done_q: "queue.Queue" = queue.Queue()
    req_cls = request_class(done_q)
    traffic = loadgen.Traffic(cell.mix, seed, model.cfg.vocab_size)
    if any(traffic.docs):
        send_and_wait(engine, req_cls, done_q, traffic.docs,
                      [1] * traffic.clients, 900.0)
    marks["documents"] = time.monotonic()
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    warm_up(engine, req_cls, done_q, traffic, seed)
    marks["warm_up"] = time.monotonic()
    log(f"portbench: {marks['warm_up'] - t_start:.2f} s to the load's "
        f"start")

    stats: Dict[str, Dict] = {}
    prof: Dict[str, Any] = {}

    def on_open():
        stats["0"] = engine.stats()

    def on_trace_start():
        stats["split"] = engine.stats()
        prof["t_split"] = time.monotonic()
        # The profiler records host events of the thread that starts
        # it: start and stop it on the engine's thread.
        prof["p"] = engine._engine_call(trace.start_profiler,
                                        timeout_s=300.0)
        prof["t0_ns"] = time.time_ns()
        spans.recording = True

    def on_close():
        stats["1"] = engine.stats()
        if not traced:
            return
        spans.recording = False

        def stop():
            if on_card:
                torch.cuda.synchronize(device)
            prof["t1_ns"] = time.time_ns()
            prof["p"].stop()
        engine._engine_call(stop, timeout_s=300.0)

    events = [(seconds, on_close)]
    if traced:
        events.append((seconds - min(TRACE_S, seconds / 2), on_trace_start))
    records, t0, t1 = closed_loop(engine, req_cls, done_q, traffic,
                                  seconds, on_open, events)
    setup_s = t0 - t_start
    log(f"portbench: window closed; {len(records)} requests sent, drain "
        f"ended {time.monotonic() - t1:.2f} s after the close")
    free_engine(engine)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    run = Run(cell.conf, card, t0, t1, records, stats["0"],
              stats["1"], setup_s, flops.peaks(card) if on_card else None)
    if traced:
        spans.uninstall()
        run.t_split, run.stats_split = prof["t_split"], stats["split"]
        run.trace = trace.reduce_trace(prof["p"], *_profiler_window(prof))
        run.trace["user_scope_only"] = prof["p"].user_scope_only
        if on_card:
            run.kernel_work = kernel_work(spans.calls, card)
        spans.calls.clear()
        prof.clear()

    # Ended by the engine inside the window: the loop's cancellations
    # after the close end requests short, and those are not answers.
    finished = [r for r in records if r.req.done.is_set()
                and r.req.t_done <= t1 and not r.error and r.req.t_tokens]
    picks = check.draw_sample(finished, seed,
                              int(cell.limits["sample_tokens"]),
                              int(cell.limits["sample_requests"]))
    t_ref = time.monotonic()
    got = check.readings(model, cell.conf, picks, control) if picks else {}
    t_ref = time.monotonic() - t_ref
    log(f"portbench: reference over {len(picks)} requests in {t_ref:.2f} s")
    wrong_len = sum(1 for r in picks if len(r.tokens) != r.max_tokens)
    compare = cell.limits["compare"]
    checks = {k: {"value": got.get(k, math.inf), "limit": float(v)}
              for k, v in compare.items()}
    checks["wrong_length"] = {"value": wrong_len, "limit": 0}
    checks["sampled"] = {"value": len(picks), "limit": 1}
    correct = bool(picks) and wrong_len == 0 and all(
        checks[k]["value"] <= checks[k]["limit"] for k in compare)

    metrics: Dict[str, Dict] = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        reader = load_file(os.path.join(PB, "metrics", m["name"] + ".py"),
                           "portbench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is None:
            continue
        if not math.isfinite(value):
            raise RuntimeError(f"metric {m['name']} has no finite value")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    sent = run.sent_in_window()
    failed = sum(1 for r in sent if r.failed)
    dev = {"platform": "gpu" if on_card else "cpu", "kind": card,
           "count": 1, "memory_peak_bytes": int(peak)}
    result: Dict[str, Any] = {"correct": correct, "attempted": len(sent),
                              "failed": failed, "metrics": metrics,
                              "device": dev}
    if traced:
        dev["busy_s"] = run.trace["busy_s"]
        dev["window_s"] = run.trace["window_s"]
        result["breakdown"] = {"device_ops": run.trace["device_ops"],
                               "idle_gaps": run.trace["idle_gaps"]}
    steps = list(marks.items())
    result["setup_split_s"] = {k: steps[i][1] - steps[i - 1][1]
                               for i, (k, _) in enumerate(steps) if i}
    result["setup_split_s"]["start_burst"] = t0 - marks["warm_up"]
    result["reference_s"] = t_ref
    result["max_logit_gap"] = got.get("max_logit_gap")
    result["mean_logit_gap"] = got.get("mean_logit_gap")
    result["served_tokens_read"] = got.get("served_tokens_read", 0)
    result["not_first_choice"] = got.get("not_first_choice", 0)
    if traced:
        result["trace_kernels"] = run.trace["kernels"]
        result["trace_unmatched_kernels"] = run.trace["unmatched_kernels"]
        result["trace_user_scope_only"] = run.trace["user_scope_only"]
        # What tracing costs the host: tokens/s before and inside it.
        a, b = run.untraced
        result["untraced_tok_s"] = run.tokens_between(a, b) / (b - a)
        result["traced_tok_s"] = run.tokens_between(b, t1) / (t1 - b)
    for k in ("control", "gaps", "control_gaps"):
        if k in got:
            result[k] = got[k]
    result["checks"] = checks
    result["_run"] = run
    return result


def _profiler_window(prof) -> tuple:
    """The window in the profiler's clock (Unix time in ns). Should the
    events lie on another clock, the window is their own extent."""
    t0, t1 = prof["t0_ns"], prof["t1_ns"]
    evs = prof["p"].profiler.kineto_results.events()
    starts = [e.start_ns() for e in evs[:1000]]
    if starts and abs(min(starts) - t0) > 3600 * 10 ** 9:
        return (min(e.start_ns() for e in evs),
                max(trace.end_ns(e) for e in evs))
    return t0, t1


def forbidden_modules() -> List[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)
                   if n.split(".")[0] in FORBIDDEN})
