"""tpushare-torch-serve: the HTTP serving daemon over the port's slot
servers. Counterpart of ``tpushare/cli/serve.py`` (``tpushare-serve``):
the same endpoints, JSON, ``/stats`` keys and nulls, and failure
domains, on PyTorch and an NVIDIA card.

Design: one ENGINE thread owns the model and the slot server (the
server's tensors are mutated from exactly one thread at a time); HTTP
handlers only enqueue requests and wait on a per-request event, and
read nothing but host state. The engine loop admits pending prompts
into free slots, advances every active slot one token per iteration
(one batched step), and completes requests at max_tokens or EOS.
Every thread that touches the slot server (the engine thread, each one
the supervisor restarts, shutdown) enters ``torch.inference_mode()``
and the server's CUDA device itself: both are per thread.

API (token ids in, token ids out — tokenization is the caller's):

  POST /v1/completions  {"prompt": [int, ...], "max_tokens": N,
                         "eos": int (optional),
                         "adapter": i (optional multi-LoRA bank index,
                                       -1 = base model; a bool or an
                                       index outside the bank is a 400),
                         "stream": bool (optional),
                         "tier": str, "tenant": str (optional)}
      -> {"id": rid, "tokens": [int, ...], "cached_prefix": C}
      -> stream=true: text/event-stream of `id: N` + `data:
         {"token": t}` events as tokens decode (N = tokens delivered so
         far, the resume cursor), closing with `data: {"done": true,
         "cached_prefix": C}` (or `data: {"error": ...}`); the request
         id rides the `X-Request-Id` header; a client disconnect
         cancels the generation and frees the slot.
         An `Idempotency-Key` header makes the admission exactly-once:
         a retried POST with the same key re-attaches to the live
         request or returns the completed result; the same key with a
         DIFFERENT prompt is a 409. The dedupe window is journal-backed
         (--journal-dir), so it survives process death.
  GET /v1/completions/{id}?from=N
                        -> resume a stream mid-generation (Last-Event-ID
                           is honored when ?from= is absent),
                           byte-identical to the uninterrupted stream's
                           token events; 404 for an unknown id
  GET /healthz          -> liveness (a draining/restarting replica is
                           still live)
  GET /readyz           -> readiness: 503 while draining/restarting
  GET /prefixes         -> prefix-cache gossip (hex chain keys; null for
                           the dense-row MoE family)
  GET /stats            -> slots / pool / prefix-cache / recovery counters
  POST /drain, /undrain -> stop / resume accepting new work
  POST /mesh/chip       {"device": i | "chip": c, "healthy": bool}
                        -> a sharded engine's card changed health:
                           unhealthy reshards the mesh around it
                           (degrade-and-replay), every card healthy
                           again grows it back at an idle tick; an
                           unsharded engine's chip IS its whole domain:
                           unhealthy drains, healthy undrains
  POST /mesh/host       {"rank": h, "healthy": bool}
                        -> a whole host of the process view (its rank
                           range) changed health; 400 without a
                           process-aware mesh
  GET /kv/blocks?keys=<hex>,<hex>
                        -> raw KV block payloads by chain digest (the
                           migration source): {"block_size": bs,
                           "blocks": {hex: {field: {"dtype", "shape",
                           "b64"}}}}, the reference's wire format; keys
                           it no longer holds are omitted
  POST /kv/migrate      {"source": url, "keys": [hex, ...],
                         "tenant": str (optional)}
                        -> pull a sibling's chain into this replica's
                           host tier (--host-kv-bytes): {"migrated": N,
                           "decision": "transfer"|"recompute"|"no_tier"}

Failure domains: a NaN token quarantines its slot; an exception out of
a tick (a kernel wrapper's included) quarantines every in-flight slot;
quarantined requests replay from the queue front carrying their
already-generated tokens (token-exact under greedy), bounded by
--max-replays before a clean 503; a crashed engine thread is restarted
by the supervisor with backoff before /healthz goes red
(--max-engine-restarts); a tick stuck past --tick-wedge-ms is escalated
to a hard engine restart through the same bounded path. With
--journal-dir every accepted request is journaled (``durable``: ACCEPT
-> per-tick TOKENS -> DONE/CANCEL/FAILED), and a killed daemon
restarted on the same directory finishes every accepted stream
token-exact. The engine never switches a kernel for its plain version
on its own: a kernel that fails is a tick fault like any other.
``chaos`` exercises every path deterministically (--chaos-spec /
TPUSHARE_CHAOS).

Host KV tier (--host-kv-bytes): blocks an admission reclaims are
demoted to page-locked host memory, tier-resident chains are promoted
back (prefetched on a side stream inside the overlapped tick's flight
window), and siblings' chains land through /kv/migrate. Handler threads
never touch pool tensors or the tier's host slots being written: the
device-resident part of /kv/blocks and every landing run on the engine
thread between ticks (``_engine_call``).

Sharded serving (``--mesh tp=2``, ``ServeEngine(mesh=)``): one process
per rank of a ``parallel.mesh.ServingMesh``, each holding its slices of
the weights and KV. Rank 0 runs this engine and its HTTP surface; its
slot server broadcasts every state-changing call to the other ranks
(``parallel/control.py``), which run the same server under
``--rank N`` and replay the calls (``ServeEngine.follow``). Every
process is given ``--dist-init tcp://localhost:<port>``. ``/stats``
names the mesh's shape, its card count and the collectives' transport.

Mesh failure domain: a card lost under a sharded engine (POST
/mesh/chip, the ``mesh.chip_failure`` chaos point, a collective's
transport error) quarantines every in-flight request, re-carves the
largest healthy sub-mesh (``models/reshard.py``) and replays the
requests token-exact on it — a new mesh generation, for which every
rank drops its server, frees its card's memory and rebuilds its slices
from a weight copy off the mesh (a host copy, or
``--reshard-checkpoint``); bounded by ``--max-reshards``, after which
the replica drains sticky. Once every card is healthy the engine grows
back at an idle tick. ``--process-view N`` groups the ranks into N
hosts: rank 0 runs the gang liaison (``parallel/gang.py``) one port
above ``--dist-init``, and a host whose heartbeats stop (or POST
/mesh/host, or the ``host.loss`` chaos point) loses its whole rank
range; a restarted rank process stands by and rejoins at the
grow-back.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import queue
import signal
import sys
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import resolve_device
from tpushare_torch.chaos import ENV_CHAOS, InjectedFault, Injector
from tpushare_torch.durable import journal as durable_journal
# Host arithmetic only: tiering and quotas add no device sync to the
# tick.
from tpushare_torch.slo import (DEFAULT_TIER, KvQuota, TickScheduler,
                                TierStats, choose_victim, parse_tier,
                                tier_rank)
from tpushare_torch.utils import ownership as _ownership

# Machine-readable cross-class ownership contracts, read by the static
# gate (tpushare_torch/analysis/threads.py) beside the inline
# `# tpushare: owner[...]` declarations. The engine/supervisor pair is
# SERIALIZED, not concurrent: the supervisor touches engine-owned state
# only after _join_or_watchdog observes the engine thread dead (or
# abandons a wedged generation), the handover _adopt_ownership makes at
# run time, so its writes to owned fields (draining, quarantine, the
# reshard between generations) are sanctioned. KvQuota and TierStats
# are owned by the engine that charges them; their snapshot() methods
# are the one sanctioned cross-thread reader each, held to the one-site
# atomic-copy discipline by TO902.
TPUSHARE_OWNERSHIP = {
    "owners": {"KvQuota.used": "engine"},
    "readers": ["KvQuota.snapshot", "TierStats.snapshot"],
    "serialized": [["engine", "supervisor"]],
}


def _mesh_axes(mesh):
    from tpushare_torch.models.serving import mesh_axes
    return mesh_axes(mesh)


# The gang liaison's watch loop prints a failed poll at most once in
# this many seconds (each printed line gives the count so far).
LIAISON_LOG_INTERVAL_S = 30.0


# Words of a collective's transport error (a dead or departed peer):
# gloo's closed connection, an NCCL or store failure.
_TRANSPORT_WORDS = ("Connection closed by peer", "Connection reset",
                    "NCCL", "ProcessGroup", "gloo", "Broken pipe")


def dist_errors() -> tuple:
    """torch.distributed's own error classes (an empty tuple where the
    build has none)."""
    err = getattr(torch.distributed, "DistError", None)
    return (err,) if err is not None else ()


# How long a mesh generation waits for a process of the old one to free
# its card's memory before taking it for dead: a follower finishes the
# call it is replaying first (seconds at Llama-3-8B's width over gloo).
RESHARD_ACK_S = 20.0

# After a failed grow-back (the engine serves on again at its degraded
# shape), the seconds before an idle tick tries the grow again: a full
# rebuild of each shape takes seconds at Llama-3-8B's width.
GROW_RETRY_S = 2.0

# How long stop() waits, in all, for the threads an engine started: a
# tick is tens to hundreds of ms, so a thread alive after this is wedged.
STOP_JOIN_S = 30.0

# The smallest chunked-admission size the daemon accepts without
# --prefill-chunk-force (the reference engine's floor, kept so the two
# daemons take the same argv; not yet measured on an NVIDIA card).
PREFILL_CHUNK_FLOOR = 512


# Wire names of the pool dtypes: numpy's names, as the reference engine
# writes them (``str(arr.dtype)``), so blocks migrate between the two
# packages; decoded with ``torch.frombuffer`` (no ml_dtypes needed for
# bfloat16).
_WIRE_DTYPES = {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16", torch.int8: "int8"}


def _wire_leaf(t: torch.Tensor) -> Dict[str, Any]:
    """One block leaf as ``{"dtype", "shape", "b64"}`` of its raw
    bytes (C order)."""
    import base64
    raw = t.contiguous().view(torch.uint8).numpy().tobytes()
    return {"dtype": _WIRE_DTYPES[t.dtype], "shape": list(t.shape),
            "b64": base64.b64encode(raw).decode()}


def _unwire_block(rec, layout) -> Optional[Dict[str, torch.Tensor]]:
    """A ``/kv/blocks`` record decoded to host tensors, or None unless
    it holds exactly this pool's leaves with its shapes and dtypes."""
    import base64
    fields = [pf for pf, _, _ in layout]
    if not isinstance(rec, dict) or set(rec) != set(fields):
        return None
    out = {}
    for pf, shape, dtype in layout:
        leaf = rec[pf]
        if (not isinstance(leaf, dict)
                or leaf.get("dtype") != _WIRE_DTYPES.get(dtype)
                or tuple(leaf.get("shape") or ()) != tuple(shape)):
            return None
        try:
            raw = bytearray(base64.b64decode(leaf["b64"]))
        except (KeyError, TypeError, ValueError):
            return None
        if len(raw) != int(np.prod(shape)) * dtype.itemsize:
            return None
        out[pf] = torch.frombuffer(raw, dtype=dtype).reshape(shape)
    return out


class _EngineSuperseded(Exception):
    """Raised inside a tick whose engine generation was escalated away
    (the wedge watchdog's hard restart): the zombie thread must abort
    WITHOUT touching the slot server or emitting tokens — its requests
    were already quarantined and replayed by the new generation."""


class _DeviceLost(BaseException):
    """The card's context is gone (a sticky CUDA error): raised out of
    the engine loop so the supervisor's bounded restart path, not the
    per-tick replay, decides the replica's fate."""


class _Request:
    def __init__(self, prompt, max_tokens: int,
                 eos: Optional[int], adapter: int = -1,
                 tier: str = DEFAULT_TIER, tenant: str = "default"):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.eos = eos
        self.adapter = adapter
        # Durable identity: the request id every response
        # carries (the stream-resume handle), the client's
        # Idempotency-Key (None = no dedupe asked), the original
        # prompt snapshot (self.prompt mutates through fold/replay;
        # the journal's ACCEPT and the key-reuse check need the
        # admission-time truth), and whether this request's ACCEPT
        # already hit the journal (replays and recovered requests
        # must never re-ACCEPT).
        self.request_id = uuid.uuid4().hex
        self.idem_key: Optional[str] = None
        self.prompt0 = list(prompt)
        self.journaled = False
        self._terminal_cb = None        # engine-installed journal hook
        # SLO identity: the priority tier the scheduler
        # orders by and the tenant the KV-block quota charges. Both
        # survive preemption and quarantine/replay — the request
        # object is the same across re-admissions, so the deadline
        # clock (t_submit) and the tier contract ride through.
        self.tier = tier
        self.tenant = tenant
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None    # first pushed token
        self.t_last: Optional[float] = None     # newest pushed token
        self.tokens: List[int] = []
        self.cached_prefix = 0
        self.error: Optional[str] = None
        self.status = 503               # error class when error is set
        self.cancelled = False          # set by a timed-out handler;
        self.done = threading.Event()   # the engine frees the slot
        self.replays = 0                # quarantine re-admissions spent
        # Generated tokens already folded into self.prompt by a
        # replay/preemption re-queue. A second re-queue must fold only
        # tokens[folded:] — re-appending the whole list would
        # duplicate the earlier tokens in the prompt and silently
        # corrupt the continuation (a latent bug in the original
        # preemption path, caught by the chaos fault storm).
        self.folded = 0
        self.seq = 0                    # admit order (preemption victim
                                        # choice: newest loses least)
        # Streaming handlers block on this instead of polling: the
        # engine notifies on every push() and on finish(), so a token
        # reaches the wire with no poll-quantum latency floor and an
        # idle stream costs zero wakeups.
        self.cond = threading.Condition()

    def push(self, tok: int) -> None:
        """Engine-side token append + wake streaming waiters."""
        now = time.monotonic()
        if self.t_first is None:
            self.t_first = now          # TTFT clock stops ONCE — a
        self.t_last = now               # replay never restarts it
        self.tokens.append(tok)
        with self.cond:
            self.cond.notify_all()

    def fold_into_prompt(self) -> None:
        """Fold the not-yet-folded generated tokens into the prompt
        for a re-admission (preemption or quarantine replay). The ONE
        home of the fold-watermark arithmetic — two hand-synced
        copies is exactly how the duplicate-prefix corruption this
        fixes crept in."""
        self.prompt = list(self.prompt) + list(self.tokens[self.folded:])
        self.folded = len(self.tokens)

    @property
    def prompt_hash(self) -> str:
        return durable_journal.prompt_hash(self.prompt0)

    def finish(self) -> None:
        """Engine-side terminal transition (done/error/cancel-reaped).
        The terminal callback (journal DONE/CANCEL/FAILED + dedupe-
        window rotation) runs BEFORE done fires — a waiter that wakes
        on done must find the terminal record already appended — and
        exactly once (finish is re-entered on some shutdown paths)."""
        cb, self._terminal_cb = self._terminal_cb, None
        if cb is not None:
            try:
                cb(self)
            except Exception:       # noqa: BLE001 — a degraded journal
                pass                # must never block the completion
        self.done.set()
        with self.cond:
            self.cond.notify_all()


class _DenseRowCacheStats:
    """The cache-shaped attribute for a server with dense KV rows
    (MoESlotServer): no block pool exists. /stats must NOT render its
    absence as ``free_blocks=0`` — autoscaling keyed on pool
    exhaustion would read an idle dense-row server as permanently
    exhausted — so the engine emits null pool counters plus the
    ``kv: "rows"`` tag for this surface (stats() branches on this
    class)."""

    def __init__(self, n_slots: int):
        self.n_slots = n_slots


class _MoEServerAdapter:
    """MoESlotServer behind the slice of the PagedSlotServer surface
    ServeEngine drives (admit/step/evict, active, last_token, stats
    counters). Paged-only concepts report their identity values; the
    engine's preemption path never triggers (dense rows are reserved
    whole at admit, so step() cannot run out of pool mid-flight)."""

    def __init__(self, inner):
        self._inner = inner
        self.cfg = inner.cfg
        self.cache = _DenseRowCacheStats(inner.n_slots)

    @property
    def speculative(self):
        return self._inner.speculative

    @property
    def gamma(self):
        return self._inner.gamma

    @property
    def spec_horizon(self):
        return self._inner.spec_horizon

    @property
    def spec_rounds(self):
        return self._inner.spec_rounds

    def spec_accept_rate(self):
        return self._inner.spec_accept_rate()

    @property
    def last_cached_len(self):
        return self._inner.last_cached_len

    @property
    def prefix_hit_tokens(self):
        return self._inner.prefix_hit_tokens

    @property
    def prefix_prompt_tokens(self):
        return self._inner.prefix_prompt_tokens

    @property
    def active(self):
        return self._inner.active

    @property
    def last_token(self):
        return self._inner.last_token

    @property
    def admitting_count(self):
        return self._inner.admitting_count

    @property
    def admission_slots(self):
        return self._inner.admission_slots

    @property
    def device_fetches(self):
        return self._inner.device_fetches

    @staticmethod
    def _check_adapter(adapter):
        if adapter not in (-1, None):   # -1 = base model (the default)
            raise ValueError("MoE serving has no adapter bank "
                             "(multi-LoRA is a dense-server feature)")

    def admit(self, prompt, adapter: int = -1):
        self._check_adapter(adapter)
        return self._inner.admit(prompt)

    def admit_start(self, prompt, adapter: int = -1,
                    chunk_tokens=None):
        self._check_adapter(adapter)
        if chunk_tokens is None:
            # Unreachable from the engine (it always passes its
            # clamped --prefill-chunk); default to the enforced floor.
            chunk_tokens = PREFILL_CHUNK_FLOOR
        return self._inner.admit_start(prompt,
                                       chunk_tokens=chunk_tokens)

    def admit_step(self, slot: int, max_chunk_tokens=None):
        return self._inner.admit_step(slot,
                                      max_chunk_tokens=max_chunk_tokens)

    def step(self, prefill_work=None, max_chunk_tokens=None):
        return self._inner.step(prefill_work=prefill_work,
                                max_chunk_tokens=max_chunk_tokens)

    def step_async(self, prefill_work=None, max_chunk_tokens=None):
        return self._inner.step_async(prefill_work=prefill_work,
                                      max_chunk_tokens=max_chunk_tokens)

    def evict(self, slot: int) -> None:
        self._inner.evict(slot)


class _PendingTick:
    """One in-flight overlapped dispatch: the PendingStep whose fetch
    is deferred to the NEXT tick, stamped with the engine generation
    and tick id it was dispatched under so a fault in the overlap
    window quarantines exactly the dispatched tick's slots, plus the
    slot->request identity map at dispatch time (a slot recycled while
    the tick was in flight must not receive the old dispatch's token).
    ``dispatch_fetches`` is the device-fetch delta the dispatch itself
    paid (normally zero; the eager monkeypatch fallback pays its fetch
    up front), so /stats fetch accounting stays exact either way."""

    __slots__ = ("step", "engine_gen", "tick_id", "slot_reqs", "work",
                 "dispatch_fetches", "retired")

    def __init__(self, step, *, engine_gen, tick_id, slot_reqs, work,
                 dispatch_fetches):
        self.step = step
        self.engine_gen = engine_gen
        self.tick_id = tick_id
        self.slot_reqs = dict(slot_reqs)
        self.work = work
        self.dispatch_fetches = int(dispatch_fetches)
        # {slot: request} capacity-retired rows pre-reaped out of the
        # engine's _active while this tick was in flight (their final
        # tokens are emitted at finalize).
        self.retired: Dict[int, "_Request"] = {}


class ServeEngine:
    """Single-threaded engine loop around a PagedSlotServer — or, with
    ``model_family="moe"``, around the MoE LM: ``kv="rows"`` (default)
    wraps an MoESlotServer (dense KV rows, chunked prefill, a row-level
    prefix cache), ``kv="paged"`` serves MoE over the same
    PagedSlotServer block pool via ``moe.paged_forward``. Features with
    no MoE analog (kv_quant) are rejected loudly; int8 expert weights
    ride ``layers_hook``. ``device``: where the server runs (None = the
    CUDA card; raises without one)."""

    def __init__(self, params, cfg, *, n_slots: int = 8,
                 n_blocks: int = 256, block_size: int = 16,
                 max_blocks_per_slot: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 kv_quant: bool = False,
                 multi_lora=None, mlora_scale: float = 1.0,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, idle_sleep_s: float = 0.005,
                 max_queue: int = 64,
                 prefill_chunk: Optional[int] = None,
                 tick_token_budget: Optional[int] = None,
                 speculative_draft=None, gamma: int = 4,
                 spec_horizon: int = 1,
                 draft_layers_hook=None,
                 model_family: str = "dense",
                 kv: Optional[str] = None,
                 max_len: int = 4096,
                 layers_hook=None,
                 chaos_spec: Optional[str] = None,
                 tick_deadline_ms: Optional[float] = None,
                 max_replays: int = 3,
                 max_engine_restarts: int = 3,
                 restart_backoff_s: float = 0.05,
                 mesh=None, param_specs=None, draft_param_specs=None,
                 default_tier: str = DEFAULT_TIER, tier_specs=None,
                 tenant_quotas=None,
                 reshard_checkpoint: Optional[str] = None,
                 journal_dir: Optional[str] = None,
                 journal_fsync: str = "tick",
                 dedup_window: int = 1024,
                 tick_wedge_ms: Optional[float] = None,
                 overlap_tick: bool = True,
                 host_kv_bytes: int = 0,
                 num_processes: int = 1,
                 gang=None,
                 max_reshards: int = 3,
                 device=None):
        if reshard_checkpoint is not None and mesh is None:
            raise ValueError(
                "reshard_checkpoint is a mesh feature (the reshard "
                "path rebuilds weights after chip loss); pass mesh= "
                "or drop it")
        if num_processes < 1:
            raise ValueError("num_processes must be >= 1")
        if num_processes > 1 and mesh is None:
            raise ValueError(
                "num_processes > 1 is a mesh feature (the process "
                "axis partitions a mesh's ranks); pass mesh=")
        if kv not in (None, "rows", "paged"):
            raise ValueError(f"unknown kv {kv!r}; 'rows' or 'paged'")
        # A speculative round is UNSPLITTABLE (acceptance is decided on
        # device), so one slot's round emits up to gamma x horizon + 1
        # tokens in its tick whatever the budget says: a budget below
        # that granule is a self-contradictory config. Checked before
        # any server is built (pure int arithmetic).
        if (speculative_draft is not None and tick_token_budget
                and tick_token_budget < gamma * spec_horizon + 1):
            raise ValueError(
                f"tick_token_budget={tick_token_budget} is below the "
                f"speculative round granule gamma*spec_horizon+1 = "
                f"{gamma * spec_horizon + 1}: a spec round cannot be "
                f"split (acceptance is decided on device), so every "
                f"round would emit past this budget and breach the "
                f"per-tick bound it promises. Raise the budget or "
                f"lower --gamma/--spec-horizon")
        if mesh is not None and host_kv_bytes:
            raise ValueError(
                "host_kv_bytes does not compose with mesh sharding yet "
                "(a sharded pool's block rows are split across ranks; "
                "the host copy/restore contract here is single-device "
                "— documented seam, like kv_quant-on-mesh)")
        # Resolved first, so a missing card fails before any weights or
        # pools are placed. On a mesh: this rank's card.
        self._mesh = mesh
        self.device = (mesh.device if mesh is not None
                       else resolve_device(device))
        # Per-tenant KV-block quotas (slo.quota) layer on the paged
        # pool's counters; dense KV rows have no block pool to meter, so
        # quotas there are a loud error, not a silent no-op.
        self._kv_quota = KvQuota(tenant_quotas) if tenant_quotas else None
        if self._kv_quota is not None and (model_family == "moe"
                                           and (kv or "rows") == "rows"):
            raise ValueError(
                "tenant_quotas meter paged KV-pool blocks; "
                "model_family='moe' with kv='rows' has no block pool "
                "(serve --kv paged for quota-aware MoE)")
        use_prefix = True if prefix_cache is None else prefix_cache
        if model_family == "moe" and kv == "paged":
            from tpushare_torch.models.moe import paged_forward
            from tpushare_torch.models.paged import PagedSlotServer
            if kv_quant or multi_lora is not None:
                raise ValueError(
                    "model_family='moe' does not support kv_quant/"
                    "multi_lora (dense-LM features; pass layers_hook="
                    "quant.dequant_hook(cfg) for int8 expert weights)")

            def factory(f_params, f_draft, f_mesh, f_quota, dev):
                return PagedSlotServer(
                    f_params, cfg, n_slots=n_slots, n_blocks=n_blocks,
                    block_size=block_size,
                    max_blocks_per_slot=max_blocks_per_slot,
                    prefix_cache=use_prefix,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, layers_hook=layers_hook,
                    speculative_draft=f_draft, gamma=gamma,
                    spec_horizon=spec_horizon,
                    draft_layers_hook=draft_layers_hook,
                    forward_fn=paged_forward, kv_quota=f_quota,
                    mesh=f_mesh, param_specs=param_specs,
                    draft_param_specs=draft_param_specs, device=dev)
        elif model_family == "moe":
            unsupported = {
                "kv_quant": kv_quant,
                "max_blocks_per_slot": max_blocks_per_slot is not None,
                "multi_lora": multi_lora is not None,
            }
            bad = [k for k, v in unsupported.items() if v]
            if bad:
                raise ValueError(
                    f"model_family='moe' does not support {bad} "
                    f"(moe.MoESlotServer docstring; pass "
                    f"layers_hook=quant.dequant_hook(cfg) for int8 "
                    f"expert weights instead)")
            from tpushare_torch.models.moe import MoESlotServer

            # prefix_cache=None is "unset": both families default it on
            # (MoE's is the row-level variant).
            def factory(f_params, f_draft, f_mesh, f_quota, dev):
                return _MoEServerAdapter(MoESlotServer(
                    f_params, cfg, n_slots=n_slots, max_len=max_len,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, layers_hook=layers_hook,
                    prefix_cache=use_prefix,
                    speculative_draft=f_draft, gamma=gamma,
                    spec_horizon=spec_horizon,
                    draft_layers_hook=draft_layers_hook, mesh=f_mesh,
                    param_specs=param_specs,
                    draft_param_specs=draft_param_specs, device=dev))
        elif model_family != "dense":
            raise ValueError(f"unknown model_family {model_family!r}")
        else:
            if kv == "rows":
                raise ValueError("model_family='dense' serves over the "
                                 "paged pool (kv='paged' is its only "
                                 "KV layout)")
            from tpushare_torch.models.paged import PagedSlotServer

            def factory(f_params, f_draft, f_mesh, f_quota, dev):
                return PagedSlotServer(
                    f_params, cfg, n_slots=n_slots, n_blocks=n_blocks,
                    block_size=block_size,
                    max_blocks_per_slot=max_blocks_per_slot,
                    prefix_cache=use_prefix, kv_quant=kv_quant,
                    multi_lora=multi_lora, mlora_scale=mlora_scale,
                    temperature=temperature, top_k=top_k, top_p=top_p,
                    seed=seed, layers_hook=layers_hook,
                    speculative_draft=f_draft, gamma=gamma,
                    spec_horizon=spec_horizon,
                    draft_layers_hook=draft_layers_hook,
                    kv_quota=f_quota, mesh=f_mesh,
                    param_specs=param_specs,
                    draft_param_specs=draft_param_specs, device=dev)
        self._server_factory = factory
        self._cfg = cfg
        # Mesh failure domain: the configured mesh is the operator's
        # sized shape (generation 0); the CURRENT mesh (self._mesh)
        # shrinks on card loss and grows back on recovery, each shape a
        # mesh generation of its own (parallel/mesh.py). Card health is
        # engine-side truth, fed by POST /mesh/chip, /undrain
        # (all-healthy), the mesh.chip_failure chaos point and
        # classified dispatch failures; self._positions names the
        # configured positions the current ranks run on. Every rank
        # keeps a ParamStore, built before placement off the unplaced
        # trees: a dead card takes its slices with it, so rebuilds read
        # host (or disk) copies. A one-rank mesh has nothing to shrink
        # to and keeps none.
        self._mesh_configured = mesh
        self._positions = (list(range(mesh.size)) if mesh is not None
                           else None)
        self._max_reshards = max(0, int(max_reshards))
        self._degraded = False
        # The plan the degraded mesh was built on (a failed grow-back
        # rebuilds on it), and the earliest time of the next grow.
        self._serving_plan = None
        self._grow_retry_at = 0.0
        self._mesh_fault: Optional[str] = None
        self._chip_health = ([True] * mesh.size
                             if mesh is not None else None)
        self._reshard_ms: List[float] = []
        self._grow_ms: List[float] = []
        self._presumed_dead: set = set()
        # Set by the liaison thread when it aborts an NCCL generation.
        self._mesh_aborted = False
        # Rank 0's record of every ended mesh generation, and what the
        # caller adds to each (the CLI: the kernel launches so far).
        self._generations: List[Dict[str, Any]] = []
        self.generation_probe = None
        self._mesh_digests: Dict[int, str] = {}
        self._draft_cfg = (speculative_draft[1]
                           if speculative_draft is not None else None)
        self._tenant_quotas = tenant_quotas
        self._param_store = None
        if mesh is not None and mesh.size > 1 and self._max_reshards:
            from tpushare_torch.models.reshard import ParamStore
            self._param_store = ParamStore(
                params,
                (speculative_draft[0] if speculative_draft is not None
                 else None),
                path=reshard_checkpoint)
        # Process axis: the mesh's ranks fall into num_processes hosts,
        # each a contiguous run of mesh.size // num_processes ranks;
        # host health rides the card-health machinery (a dead host is
        # its whole rank range going unhealthy at once). A one-host
        # engine stays topology-less (null-not-zero in /stats, 400 on
        # /mesh/host).
        self._topo = None
        if mesh is not None and num_processes > 1:
            from tpushare_torch.parallel.multihost import ProcessTopology
            if mesh.size % int(num_processes) != 0:
                raise ValueError(
                    f"mesh of {mesh.size} ranks does not divide into "
                    f"{num_processes} processes")
            self._topo = ProcessTopology.forced_view(int(num_processes),
                                                     mesh.size)
        self._host_health = ([True] * int(num_processes)
                             if self._topo is not None else None)
        # Gang liaison (parallel.gang.GangLeader on rank 0): heartbeat
        # verdicts become host events, polled in the tick preamble and,
        # while a tick may be blocked in a collective, by a liaison
        # thread of its own.
        self._gang = gang
        # Failed polls of the liaison thread (/stats keeps the
        # reference's keys; the count is in each printed line).
        self._liaison_errors = 0
        if gang is not None and (self._topo is None
                                 or self._topo.num_processes < 2):
            raise ValueError(
                "a gang liaison needs num_processes >= 2 on a mesh")
        self._gang_follower = None
        # Serializes /stats (and the other handler reads of the server)
        # against a rebuild, which drops the old server before it
        # builds the new one.
        self._swap_lock = threading.RLock()
        self.srv = None
        if mesh is None or not mesh.standby:
            self.srv = self._build_server(params, speculative_draft, mesh,
                                          self._kv_quota)
        self.model_family = model_family
        self._has_pool = not (model_family == "moe"
                              and (kv or "rows") == "rows")
        self.kv = "paged" if self._has_pool else "rows"
        # Bounded queue: a request flood gets an immediate 429 instead
        # of an unbounded queue + one parked handler thread per request.
        self._max_queue = max(1, max_queue)
        self._pending: "queue.Queue[_Request]" = queue.Queue(
            maxsize=self._max_queue)
        # Tier-aware admission order: the intake queue above stays a
        # flat FIFO (handlers only enqueue); the engine drains it into
        # the scheduler's per-tier queues, which decide who admits next
        # (weighted fairness across tiers, strict priority when an
        # interactive deadline is at risk). Intake is BOUNDED (the
        # scheduler backlog stops draining at max_queue, so the flood
        # backstop stays the Queue's 429). Pool-pressure re-admits,
        # preempted victims and quarantine replays push_front into the
        # request's own tier.
        self._sched = TickScheduler(tier_specs, default_tier)
        self._tier_stats = TierStats(self._sched.specs)
        # Quota-ceiling holds wait OUT of the tier rotation (only their
        # own tenant's refunds can cure them) — re-queued by
        # _unpark_tenant.
        self._quota_parked: List[_Request] = []     # tpushare: owner[engine]
        self._active: Dict[int, _Request] = {}      # tpushare: owner[engine]
        # Chunked prefill: a long prompt's admission is split into
        # block-aligned chunks FUSED into the decode batch
        # (srv.step(prefill_work=...): one model forward serves both).
        # None = whole-prompt admits.
        self._prefill_chunk = prefill_chunk
        # Per-tick token budget (decode rows + fused chunk tokens):
        # bounds fused-tick latency. 0/None = unbounded (full chunk).
        # When the budget leaves no room for even one chunk granule
        # beside the decode batch, the engine alternates decode-only
        # and admission-only ticks so neither side starves.
        self._tick_token_budget = int(tick_token_budget or 0)
        self._admit_turn = False
        self._chunk_gran = block_size if self._has_pool else 1
        self._admitting: Dict[int, _Request] = {}   # tpushare: owner[engine]
        self._idle_sleep_s = idle_sleep_s
        self.max_tokens_cap = 4096
        self._seq = 0
        self._stats = {"requests": 0, "completed": 0, "rejected": 0,
                       "preempted": 0, "chunked_admits": 0, "steps": 0,
                       "fused_ticks": 0, "model_forwards": 0,
                       "work_ticks": 0, "device_fetches": 0,
                       "tokens_out": 0, "slot_rounds": 0,
                       "engine_errors": 0, "last_error": None,
                       "quarantines": 0, "replays": 0,
                       "engine_restarts": 0, "deadline_breaches": 0,
                       "evict_errors": 0,
                       # Mesh and host failure domains: reshards
                       # (degrade-and-replay), grow-backs, requests
                       # replayed by a reshard, hosts lost and back.
                       "reshards": 0, "grow_backs": 0,
                       "replayed_on_reshard": 0,
                       "host_losses": 0, "host_rejoins": 0,
                       # Process failure domain: journal-recovered
                       # replays at boot, idempotency-key dedupe hits,
                       # mid-generation stream resumes, and wedge
                       # watchdog hard restarts.
                       "recovered_requests": 0, "dedup_hits": 0,
                       "resumed_streams": 0, "wedge_escalations": 0,
                       # Monotonic engine-loop iterations (idle ticks
                       # included): the loop's liveness signal.
                       "ticks": 0}
        self._engine_t0 = time.monotonic()
        # Typed transient-pressure exceptions: the admission and
        # preemption paths catch EXACTLY these — any other runtime error
        # (a kernel wrapper's included) is a device/engine failure and
        # must reach the quarantine path.
        from tpushare_torch.models.paged import (PoolExhausted,
                                                 QuotaExceeded,
                                                 SlotCapacityExceeded)
        self._pool_exhausted = PoolExhausted
        self._quota_exceeded = QuotaExceeded
        self._slot_cap_exceeded = SlotCapacityExceeded
        # Fault injection (chaos): fault points resolve ONCE here — an
        # unarmed point is the shared no-op.
        if chaos_spec is None:
            chaos_spec = os.environ.get(ENV_CHAOS, "")
        self._chaos = Injector.from_spec(chaos_spec,
                                         deadline_ms=tick_deadline_ms)
        self._fault_forward = self._chaos.point("engine.tick.forward")
        self._fault_token_fetch = self._chaos.point("engine.token_fetch")
        self._fault_admit = self._chaos.point("engine.admit")
        self._fault_kill = self._chaos.point("process.kill")
        self._fault_chip = self._chaos.point("mesh.chip_failure")
        self._fault_host = self._chaos.point("host.loss")
        # Host KV offload tier: cold paged blocks demote to host memory
        # under this byte budget instead of being destroyed, admissions
        # promote tier-resident chains back (prefetched in the overlap
        # window), and sibling replicas land migrated chains here via
        # POST /kv/migrate. 0 = no tier.
        self._host_tier = None
        if host_kv_bytes:
            if not self._has_pool:
                raise ValueError(
                    "host_kv_bytes needs the paged KV pool (dense "
                    "MoE rows have no blocks to demote; serve "
                    "--kv paged)")
            if not use_prefix:
                raise ValueError(
                    "host_kv_bytes needs prefix_cache: demoted "
                    "blocks are keyed (and promoted) by their chain "
                    "digests, which only the prefix cache computes")
            from tpushare_torch.models.kvtier import HostKvTier
            from tpushare_torch.models.paged import attach_host_tier
            self._host_tier = HostKvTier(int(host_kv_bytes),
                                         quota=self._kv_quota)
            self._host_tier.fault_demote = self._chaos.point("kv.demote")
            self._host_tier.fault_promote = \
                self._chaos.point("kv.promote")
            attach_host_tier(self.srv.cache, self._host_tier)
        # Overlap-window prefetch failures (best effort: the admission
        # pays its own upload instead): counted, never raised.
        self._prefetch_errors = 0
        # Work a handler thread hands the engine thread (the pool reads
        # of /kv/blocks, migrated landings): served between ticks.
        self._engine_calls: "queue.Queue" = queue.Queue()
        # Per-tick deadline (ms): a tick running longer counts a
        # breach (the hang-detection signal operators alert on).
        self._tick_deadline_ms = tick_deadline_ms or None
        # Bounded recovery: per-request replay budget, engine-thread
        # restart budget, supervisor backoff base.
        self._max_replays = max(0, int(max_replays))
        self._max_engine_restarts = max(0, int(max_engine_restarts))
        self._restart_backoff_s = restart_backoff_s
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._drain_sticky = False      # shutdown drain: no undrain
        # Request popped from the queue but not yet placed into
        # _active/_admitting/the scheduler: drain()'s idle check must
        # see it. _pop_lock makes the pop->_popped handoff atomic
        # against that check.
        self._popped: Optional[_Request] = None     # tpushare: lock[_pop_lock]
        self._pop_lock = threading.Lock()
        self._tick_started: Optional[float] = None  # in-flight tick t0
        # -- process failure domain ------------------------------------
        # The durable request registry: every HTTP-submitted request by
        # id (the resume handle), the Idempotency-Key -> id map (the
        # dedupe window), and a bounded FIFO of completed ids. Handler
        # threads and the engine both touch these — every mutation
        # holds _durable_lock.
        self._durable_lock = threading.Lock()
        self._requests: Dict[str, _Request] = {}    # tpushare: lock[_durable_lock]
        self._dedup: Dict[str, str] = {}            # tpushare: lock[_durable_lock]
        self._dedup_window = max(8, int(dedup_window))
        self._completed_order = collections.deque()  # tpushare: lock[_durable_lock]
        # Journal: _jrnl_tick batches this tick's per-request emissions
        # into ONE TOKENS record each, written at tick end off the
        # tick's one existing device fetch.
        self._journal: Optional[durable_journal.Journal] = None
        self._jrnl_tick: Dict[_Request, List[int]] = {}  # tpushare: owner[engine]
        self._jrnl_open = 0             # journaled, not yet terminal
        self._jrnl_dirty = False        # real records since checkpoint
        if journal_dir:
            recovered = durable_journal.scan(journal_dir)
            self._journal = durable_journal.Journal(
                journal_dir, fsync=journal_fsync,
                fault_write=self._chaos.point("journal.write"),
                fault_fsync=self._chaos.point("journal.fsync"))
            self._recover_journal(recovered)
        # Wedge watchdog: the engine GENERATION the current loop thread
        # belongs to. The supervisor escalates a tick stuck past
        # tick_wedge_ms by bumping the generation — the wedged thread
        # aborts at its next seam.
        self._tick_wedge_ms = tick_wedge_ms or None
        # Overlapped tick pipeline: while tick N's dispatch is in flight
        # on the card, tick N+1 runs its host-side work (journal fsync,
        # admission drain, scheduling) and only then finalizes tick N's
        # one deferred device fetch. _pending_tick holds the in-flight
        # dispatch (None = pipeline empty).
        self._overlap_tick = bool(overlap_tick)
        self._pending_tick: Optional[_PendingTick] = None  # tpushare: owner[engine]
        self._pipeline_flushes = 0
        # Host-gap ring (overlap mode only): wall-clock from one
        # finalize to the next dispatch's launch — the host-side span
        # the overlap is hiding.
        self._host_gap_ms: List[float] = []     # tpushare: owner[engine]
        self._gap_anchor: Optional[float] = None
        self._dispatch_seq = 0          # tick-generation stamp source
        # Next-tick pick plan, precomputed in the overlap window off a
        # quota-ledger snapshot (pure host work).
        self._next_pick_plan = None
        self._engine_gen = 0
        self._thread = threading.Thread(target=self._loop, args=(0,),
                                        name="engine-0", daemon=True)
        # The loop supervisor owns the engine thread's lifecycle: it
        # (re)starts _loop with backoff when a lethal error kills the
        # thread and gives up — /healthz goes red — after
        # max_engine_restarts.
        self._supervisor = threading.Thread(target=self._supervise,
                                            name="engine-supervisor",
                                            daemon=True)
        self._started = False
        # Opt-in runtime ownership checks (TPUSHARE_OWNERSHIP_CHECKS=1):
        # declared-owner fields assert their writer thread. A no-op when
        # the env var is off.
        _ownership.install(self, "engine",
                           ("_quota_parked", "_active", "_admitting",
                            "_jrnl_tick"))
        _ownership.install(self._tier_stats, "engine",
                           ("_c", "_ttft", "_per_tok"))
        if self._kv_quota is not None:
            _ownership.install(self._kv_quota, "engine", ("used",))

    @contextlib.contextmanager
    def _on_device(self):
        """Grad mode and the current CUDA device are per thread: every
        thread that runs the slot server (the engine loop, each restart
        of it, the supervisor's recovery, shutdown) enters inference
        mode and the server's device itself. The kernels launch on the
        thread's current device and stream."""
        with contextlib.ExitStack() as stack:
            stack.enter_context(torch.inference_mode())
            if self.device.type == "cuda":
                stack.enter_context(torch.cuda.device(self.device))
            yield

    def _adopt_ownership(self) -> None:
        """Bind the engine-owned state to the calling thread: the loop
        thread at its top, the supervisor after joining a dead engine,
        stop() after joining the supervisor — the same serialized
        handover TPUSHARE_OWNERSHIP declares statically."""
        _ownership.adopt(self)
        _ownership.adopt(self._tier_stats)
        if self._kv_quota is not None:
            _ownership.adopt(self._kv_quota)

    # -- client side -------------------------------------------------
    def submit(self, req: _Request) -> bool:
        """Enqueue; False when the queue is full (caller answers 429).
        A draining engine refuses new work with a 503 (clients retry
        another replica) while everything already accepted — queued,
        held, admitting, active — still runs to completion."""
        if self._draining.is_set():
            req.error = "server draining; retry another replica"
            req.status = 503
            req.finish()
            return True
        try:
            self._pending.put_nowait(req)
        except queue.Full:
            return False
        if self._stop.is_set():
            # Check-then-enqueue race against shutdown: _stop is set
            # BEFORE stop()'s final queue drain, so seeing it here
            # means our enqueue may have landed after the last drain —
            # no engine will ever serve this queue again. Fail the
            # stragglers ourselves or their handlers would sit on
            # done.wait() until the HTTP timeout (and server_close's
            # handler join would block that long too).
            while True:
                try:
                    r = self._pending.get_nowait()
                except queue.Empty:
                    break
                r.error = "server shutting down"
                r.finish()
        return True

    # -- durable requests --------------------------------------------
    def register_or_attach(self, req: "_Request"
                           ) -> Tuple["_Request", bool, bool]:
        """Register a fresh HTTP request — or, when its
        Idempotency-Key already names one, RE-ATTACH to it. Returns
        (request-to-serve, attached, conflict): ``attached`` means the
        caller must serve the returned (live or completed) request and
        NOT submit; ``conflict`` means the key was reused with a
        different prompt (a client bug — 409, never a silent
        re-attach). Atomic under the durable lock, so two concurrent
        retries with the same key admit exactly one request."""
        with self._durable_lock:
            if req.idem_key is not None:
                rid = self._dedup.get(req.idem_key)
                if rid is not None:
                    existing = self._requests.get(rid)
                    # A CANCELLED request is not a result: exactly-
                    # once binds completions, so a retry after a
                    # client-side abandon re-executes (once) — the
                    # key rebinds to the fresh request below instead
                    # of returning a truncated token list as a 200.
                    if existing is not None and not existing.cancelled:
                        if existing.prompt_hash != req.prompt_hash:
                            return req, False, True
                        self._stats["dedup_hits"] += 1
                        return existing, True, False
                self._dedup[req.idem_key] = req.request_id
            self._requests[req.request_id] = req
            req._terminal_cb = self._request_terminal
        return req, False, False

    def deregister(self, req: "_Request") -> None:
        """Undo a registration whose submit never landed (queue-full
        429): the key must not pin a request that will never run."""
        with self._durable_lock:
            self._requests.pop(req.request_id, None)
            if req.idem_key is not None and \
                    self._dedup.get(req.idem_key) == req.request_id:
                del self._dedup[req.idem_key]
        req._terminal_cb = None

    def request_by_id(self, request_id: str) -> Optional["_Request"]:
        """The stream-resume lookup (GET /v1/completions/{id})."""
        with self._durable_lock:
            return self._requests.get(request_id)

    def note_resumed(self) -> None:
        self._stats["resumed_streams"] += 1

    def _request_terminal(self, req: "_Request") -> None:
        """req.finish() hook: append the terminal journal record and
        rotate the request into the bounded completed window. Runs on
        whatever thread finishes the request (engine, supervisor,
        shutdown) — the journal locks internally, the window under
        the durable lock."""
        if self._journal is not None and req.journaled:
            if req.cancelled and req.error is None:
                rec = {"k": "CANCEL", "id": req.request_id}
            elif req.error is not None:
                rec = {"k": "FAILED", "id": req.request_id,
                       "err": req.error, "status": req.status}
            else:
                rec = {"k": "DONE", "id": req.request_id,
                       "n": len(req.tokens)}
            self._journal.append(rec)
            self._jrnl_dirty = True
            with self._durable_lock:
                self._jrnl_open = max(0, self._jrnl_open - 1)
        self._retain_completed(req)

    def _retain_completed(self, req: "_Request") -> None:
        """Keep the finished request inside the dedupe/resume window;
        evict the oldest completed entries past the bound (live
        requests are never evicted — they hold slots)."""
        with self._durable_lock:
            if req.request_id not in self._requests:
                return                  # never registered (direct
            self._completed_order.append(req.request_id)  # submits)
            if (req.error is not None or req.cancelled) \
                    and req.idem_key is not None \
                    and self._dedup.get(req.idem_key) == req.request_id:
                # A FAILED or CANCELLED terminal is not a result to
                # dedupe-return: the request never completed, so a
                # retry SHOULD re-execute (once) — exactly-once binds
                # completions, not refusals or abandons. The request
                # itself stays resumable by id.
                del self._dedup[req.idem_key]
            while len(self._completed_order) > self._dedup_window:
                old = self._completed_order.popleft()
                dead = self._requests.pop(old, None)
                if dead is not None and dead.idem_key is not None \
                        and self._dedup.get(dead.idem_key) == old:
                    del self._dedup[dead.idem_key]

    def _journal_accept(self, req: "_Request") -> None:
        """ACCEPT — written when the engine first drains the request
        into its tier queue (the accepted-durably point; a crash
        before this leaves the client's retry to re-execute from
        scratch, which is still exactly-once because nothing ran)."""
        if self._journal is None or req.journaled:
            return
        req.journaled = True
        self._journal.append({
            "k": "ACCEPT", "id": req.request_id, "key": req.idem_key,
            "ph": req.prompt_hash, "prompt": req.prompt0,
            "tier": req.tier, "tenant": req.tenant,
            "mt": req.max_tokens, "eos": req.eos,
            "adapter": req.adapter})
        self._jrnl_dirty = True
        with self._durable_lock:
            self._jrnl_open += 1
            # HTTP requests registered in register_or_attach already;
            # direct submits (tests, smoke runs) register here so
            # recovery and resume see every journaled request.
            if req.request_id not in self._requests:
                self._requests[req.request_id] = req
                req._terminal_cb = self._request_terminal
                if req.idem_key is not None:
                    self._dedup.setdefault(req.idem_key, req.request_id)

    def _note_emission(self, req: "_Request", tok: int) -> None:
        """Batch this tick's emissions for ONE TOKENS record per
        request at tick end — journaling must ride the tick's
        existing host work, never add per-token writes."""
        if self._journal is not None and req.journaled:
            self._jrnl_tick.setdefault(req, []).append(tok)

    def _journal_tick_end(self) -> None:
        """Tick epilogue: flush the batched TOKENS records, apply the
        fsync policy, and checkpoint-truncate on quiescence (re-
        seeding the completed window's records so the dedupe contract
        survives the truncation)."""
        if self._journal is None:
            return
        batches, self._jrnl_tick = self._jrnl_tick, {}
        for req, toks in batches.items():
            self._journal.append({
                "k": "TOKENS", "id": req.request_id,
                "s": len(req.tokens) - len(toks), "t": toks})
            self._jrnl_dirty = True
        if self._overlap_tick:
            # The fsync rides the overlap window: _journal_tick_end
            # runs post-dispatch (the _loop_once epilogue), so the
            # flusher thread's fsync overlaps the in-flight device
            # work instead of stretching the host gap. Same crash
            # class: at most the one unflushed tick's TOKENS — a torn
            # tail replay already tolerates.
            self._journal.tick_flush_async()
        else:
            self._journal.tick_flush()
        # Quiescence = nothing open ANYWHERE: journaled-not-terminal,
        # in flight (including an unfetched overlapped dispatch), OR
        # still queued (a tier-queued request's ACCEPT is already in
        # the journal — truncating under it would orphan its later
        # TOKENS records).
        if self._jrnl_dirty and self._jrnl_open == 0 \
                and not self._active and not self._admitting \
                and not self._sched.backlog() \
                and not self._quota_parked and self._pending.empty() \
                and self._pending_tick is None:
            self._journal_checkpoint()

    def _journal_checkpoint(self) -> None:
        """Quiescent checkpoint-truncate + window re-seed: the journal
        shrinks to exactly the dedupe window's completed requests (a
        post-restart retry of ANY windowed request still returns its
        completed result instead of re-executing)."""
        if not self._journal.checkpoint(self._jrnl_open):
            return
        with self._durable_lock:
            window = [self._requests[rid]
                      for rid in self._completed_order
                      if rid in self._requests]
        for req in window:
            self._journal.append({
                "k": "ACCEPT", "id": req.request_id,
                "key": req.idem_key, "ph": req.prompt_hash,
                "prompt": req.prompt0, "tier": req.tier,
                "tenant": req.tenant, "mt": req.max_tokens,
                "eos": req.eos, "adapter": req.adapter})
            if req.tokens:
                self._journal.append({
                    "k": "TOKENS", "id": req.request_id, "s": 0,
                    "t": list(req.tokens)})
            if req.cancelled and req.error is None:
                self._journal.append({"k": "CANCEL",
                                      "id": req.request_id})
            elif req.error is not None:
                self._journal.append({
                    "k": "FAILED", "id": req.request_id,
                    "err": req.error, "status": req.status})
            else:
                self._journal.append({"k": "DONE",
                                      "id": req.request_id,
                                      "n": len(req.tokens)})
        self._journal.tick_flush()
        self._jrnl_dirty = False

    def _recover_journal(self, recovered) -> None:
        """Boot-time recovery (constructor; no engine thread exists
        yet): rebuild the dedupe/resume window from completed
        requests and re-enter every unfinished one at the FRONT of
        its tier — carrying its already-generated tokens through the
        existing fold-watermark replay path, so the restarted daemon
        finishes every accepted stream token-exact under greedy."""
        reentrant: List[_Request] = []
        for rr in recovered.values():
            try:
                tier = parse_tier(rr.tier, self._sched.default_tier,
                                  specs=self._sched.specs)
            except ValueError:
                tier = self._sched.default_tier
            req = _Request(list(rr.prompt), rr.max_tokens, rr.eos,
                           rr.adapter, tier=tier, tenant=rr.tenant)
            req.request_id = rr.request_id
            req.idem_key = rr.idempotency_key
            req.prompt0 = list(rr.prompt)
            req.tokens = list(rr.tokens)
            req.journaled = True
            with self._durable_lock:
                self._requests[req.request_id] = req
                if req.idem_key and rr.status not in ("failed",
                                                      "cancelled"):
                    # failed/cancelled: exactly-once binds
                    # completions — a retry re-executes (once).
                    self._dedup[req.idem_key] = req.request_id
            if rr.status == "open":
                # Crash after the final token but before DONE: the
                # stream is complete — close it now rather than
                # re-admitting a finished request for one extra token.
                finished = (len(req.tokens) >= req.max_tokens
                            or (req.eos is not None and req.tokens
                                and req.tokens[-1] == req.eos))
                self._stats["recovered_requests"] += 1
                req._terminal_cb = self._request_terminal
                # EVERY open request counts — including the finished
                # one, whose finish() below decrements it right back.
                # Counting only the re-entrant ones would let the
                # finished branch's decrement drive the counter to
                # zero WHILE others are still open, and a premature
                # quiescence checkpoint would truncate their records.
                with self._durable_lock:
                    self._jrnl_open += 1
                if finished:
                    req.finish()
                else:
                    req.fold_into_prompt()
                    reentrant.append(req)
                continue
            # Terminal in the journal: rebuild the completed window
            # entry exactly (NO terminal re-journal — the record is
            # already durable).
            if rr.status == "cancelled":
                req.cancelled = True
            elif rr.status == "failed":
                req.error = rr.error or "failed"
                req.status = rr.error_status
            req.done.set()
            self._retain_completed(req)
        # Front of their tiers, original acceptance order preserved
        # (push_front stacks, so push in reverse).
        for req in reversed(reentrant):
            self._sched.push_front(req)

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Stop accepting new requests and wait for accepted work to
        finish — the tenant-side half of the plugin's preemption story
        (SIGTERM -> drain -> exit 0 instead of killing mid-request).
        Returns True when the engine went idle within the timeout."""
        self._drain_sticky = True       # shutdown drains never undrain
        self._draining.set()
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            # _pop_lock makes the queue-pop + _popped handoff atomic
            # against this check: without it the engine could sit
            # between get_nowait() and the _popped assignment while
            # every container reads empty.
            with self._pop_lock:
                idle = (not self._active and not self._admitting
                        and not self._sched.backlog()
                        and not self._quota_parked
                        and self._popped is None
                        and self._pending.empty()
                        and self._pending_tick is None)
            if idle:
                return True
            time.sleep(0.05)
        return False

    def begin_drain(self) -> None:
        """Non-blocking half of drain(): refuse new work immediately,
        let everything already accepted run to completion. The
        plugin's device-health churn hook (POST /drain) calls this
        when a co-located chip goes unhealthy, so in-flight streams
        finish while the scheduler stops routing new work here."""
        self._draining.set()

    def end_drain(self) -> bool:
        """Undo a churn-initiated drain (POST /undrain — the plugin's
        chip-RECOVERED hook): the chip came back, so the replica must
        rejoin service instead of 503ing forever behind a green
        /healthz. Refuses (returns False) when the drain is sticky — a
        SIGTERM/shutdown drain must never be cancelled by a
        concurrently recovering chip."""
        if self._stop.is_set() or self._drain_sticky:
            return False
        if self._chip_health is not None:
            # The plugin's undrain hook fires only once EVERY card is
            # healthy again, so undrain doubles as the all-clear for the
            # mesh domain: mark every position healthy and let the
            # engine grow back to the configured mesh at an idle tick.
            self._chip_health[:] = [True] * len(self._chip_health)
            if self._host_health is not None:
                self._host_health[:] = [True] * len(self._host_health)
            self._mesh_fault = None
        self._draining.clear()
        return True

    def _build_server(self, params, draft, mesh, quota):
        """One slot server by the engine's factory on ``mesh`` (this
        rank's card); rank 0 of a multi-rank mesh wraps it so every
        state-changing call reaches the other ranks first
        (parallel/control.py). Every rank of a generation makes this
        same call, in the same order."""
        dev = mesh.device if mesh is not None else self.device
        srv = self._server_factory(params, draft, mesh, quota, dev)
        if mesh is not None and mesh.size > 1 and mesh.rank == 0:
            from tpushare_torch.parallel.control import ShardedServer
            srv = ShardedServer(srv, mesh)
        return srv

    def chip_event(self, device: int, healthy: bool) -> Dict[str, Any]:
        """One card of the engine's mesh changed health (POST
        /mesh/chip — the plugin's per-card churn hook, an operator, or
        a test); ``device`` is its position (rank) in the configured
        mesh. An unhealthy card the serving mesh uses flags a mesh
        fault the engine thread picks up at its next tick: every
        in-flight request is quarantined and replayed token-exact on
        the largest healthy sub-mesh (degrade-and-replay). A recovered
        card marks its position healthy; the engine grows back to the
        configured mesh at an idle tick once every position is
        healthy. An unsharded engine's one card IS its whole failure
        domain: loss drains the daemon and recovery undrains."""
        if self._mesh_configured is None:
            if healthy:
                self.end_drain()
            else:
                self.begin_drain()
            return {"mesh": None, "draining": self._draining.is_set(),
                    "state": self.state()}
        device = int(device)
        n = self._mesh_configured.size
        if not (0 <= device < n):
            raise ValueError(f"device {device} out of range for the "
                             f"configured {n}-device mesh")
        self._chip_health[device] = bool(healthy)
        if not healthy:
            # Only a card the SERVING mesh uses is a fault: a re-posted
            # event for a card already resharded around must not burn
            # the reshard budget on a same-shape rebuild.
            if self._device_in_serving_mesh(device):
                self._mesh_fault = f"chip {device} reported unhealthy"
        elif self._mesh_fault is not None:
            # A flap (unhealthy-then-healthy between ticks) must not
            # rebuild a mesh that is whole again.
            if not any(not h and self._device_in_serving_mesh(i)
                       for i, h in enumerate(self._chip_health)):
                self._mesh_fault = None
        return {"mesh": True, "device": device, "healthy": bool(healthy),
                "healthy_devices": sum(self._chip_health),
                "configured_devices": n, "degraded": self._degraded,
                "state": self.state()}

    def host_event(self, rank: int, healthy: bool) -> Dict[str, Any]:
        """One whole host (process rank of the process view) of the
        engine's mesh changed health (a gang-liaison verdict, POST
        /mesh/host, the host.loss chaos point, or a test): its whole
        rank range goes unhealthy (or healthy) at once through the
        card-health machinery, so the next tick reshards across the
        host boundary and grow-back follows once every host is back.
        A lost host's processes are taken for dead: a reshard frees no
        memory of theirs and waits on none of them."""
        if self._topo is None:
            raise ValueError(
                "host_event needs a process-aware mesh (construct "
                "the engine with mesh= and num_processes=)")
        rank = int(rank)
        if not (0 <= rank < self._topo.num_processes):
            raise ValueError(
                f"rank {rank} out of range for "
                f"{self._topo.num_processes} processes")
        was = self._host_health[rank]
        self._host_health[rank] = bool(healthy)
        if was and not healthy:
            self._stats["host_losses"] += 1
        elif not was and healthy:
            self._stats["host_rejoins"] += 1
        out: Dict[str, Any] = {}
        for dev in self._topo.device_range(rank):
            out = self.chip_event(dev, healthy)
        out = dict(out)
        out.update(rank=rank,
                   healthy_processes=sum(self._host_health),
                   num_processes=self._topo.num_processes)
        return out

    def follow(self, report=None) -> int:
        """A follower process's loop: replay rank 0's server calls on
        this rank's server (``parallel.control.follow``) until rank 0
        stops; across every mesh generation rank 0 starts, leave the
        old one (drop the server, free the card's memory, release the
        groups), then rebuild this rank's slices from the ParamStore by
        the same factory call as every other rank, or stand by where
        the plan names this process no rank. ``report`` (optional) gets
        one dict per generation served: its number, this process's rank
        in it, the calls replayed, their digest and the card's peak
        memory. Returns the calls replayed in all."""
        import hashlib

        from tpushare_torch.parallel.control import (GenerationEnded,
                                                     follow)
        mesh = self._mesh
        if mesh is None or mesh.process_id in (None, 0):
            raise ValueError("follow() runs on a mesh rank above 0")
        log = (lambda m: print(m, file=sys.stderr, flush=True))
        total = 0
        while True:
            if not mesh.standby and self.srv is not None:
                self._follow_digest = hashlib.sha256()
                n, ended = 0, None
                watch = self._watch_generation(mesh)
                try:
                    with self._on_device():
                        n = follow(self.srv, mesh,
                                   digest=self._follow_digest, log=log)
                except GenerationEnded as e:
                    ended, n = "regen", e.calls
                except Exception as e:  # noqa: BLE001 — a dead peer,
                    # a desync or a silent rank 0: wait for rank 0's
                    # next plan (a reshard around the fault), bounded.
                    ended = f"{type(e).__name__}: {e}"
                    log(f"process {mesh.process_id}: generation "
                        f"{mesh.generation} ended on {ended}")
                finally:
                    watch.set()
                total += n
                self._mesh_digests[mesh.generation] = \
                    self._follow_digest.hexdigest()
                if report is not None:
                    report(self._generation_report(mesh, n))
                if ended is None:
                    return total
            nxt = mesh.wait_plan(stop=self._stop.is_set)
            if nxt is None:
                if self._stop.is_set() or mesh.stop_posted:
                    return total
                raise TimeoutError(
                    f"process {mesh.process_id}: no plan for mesh "
                    f"generation {mesh.generation + 1} within "
                    f"{mesh.timeout_s} s")
            # NCCL: abort first — freeing the card synchronizes it,
            # which would wait forever on a collective with a dead peer.
            mesh.abort()
            with self._swap_lock:
                self.srv = None
            self._free_card_memory()
            mesh.release()
            self._mesh = mesh = nxt
            if mesh.standby:
                continue
            if not self._join(mesh):
                mesh.rank = None            # wait for the next plan
                continue
            params, draft = self._param_store.load()
            self.device = mesh.device
            with self._on_device():
                srv = self._build_server(
                    params, ((draft, self._draft_cfg)
                             if draft is not None else None), mesh, None)
            with self._swap_lock:
                self.srv = srv

    def _watch_generation(self, mesh) -> threading.Event:
        """A follower over NCCL: a thread that aborts this generation's
        communicators once rank 0 posts the next plan, so a collective
        waiting on a dead peer ends with an error instead of at the
        group's timeout (gloo raises on a closed peer by itself).
        Returns the event that ends the thread."""
        done = threading.Event()
        if mesh.transport != "nccl":
            return done

        def watch():
            while not done.wait(0.05):
                if mesh.next_plan_ready():
                    mesh.abort()
                    return
        threading.Thread(target=watch, name="mesh-generation-watch",
                         daemon=True).start()
        return done

    def _join(self, mesh) -> bool:
        """Form a published generation's groups once every process it
        releases has freed its memory; False where one never does (it
        is taken for dead, and rank 0 posts another plan) or rank 0
        moved on."""
        deadline = time.monotonic() + RESHARD_ACK_S
        missing = mesh.missing_frees()
        while missing:
            if time.monotonic() > deadline or mesh.next_plan_ready():
                return False
            time.sleep(0.005)
            missing = mesh.missing_frees()
        mesh.join()
        return True

    def _generation_report(self, mesh, calls: int,
                           end: bool = True) -> Dict[str, Any]:
        """One mesh generation on this process: its number, this
        process's rank in it, its shape, the calls made, their digest,
        the card's peak memory (reset at the generation's end) and
        what ``generation_probe`` adds (the CLI: kernel launches)."""
        peak = None
        if self.device.type == "cuda":
            peak = int(torch.cuda.max_memory_allocated(self.device))
            if end:
                torch.cuda.reset_peak_memory_stats(self.device)
        out = {"mesh_generation": mesh.generation,
               "process_id": mesh.process_id, "rank": mesh.rank,
               "mesh_shape": _mesh_axes(mesh), "calls": calls,
               "digest": self._mesh_digests.get(mesh.generation),
               "peak_bytes": peak}
        if self.generation_probe is not None:
            out.update(self.generation_probe())
        return out

    def _free_card_memory(self) -> None:
        """Drop what the old server left (collected) and hand the
        card's cached blocks back, so the next generation's slices fit
        beside the other ranks' on a shared card."""
        import gc
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()

    def _stop_followers(self) -> None:
        """Rank 0: tell the other ranks to stop (once); processes
        standing by outside the current generation read the stop plan
        off the store. Ends the gang liaison's side of this process."""
        stop = getattr(self.srv, "stop", None)
        if stop is not None and self._mesh is not None:
            stop()
        mesh = self._mesh
        if mesh is not None and mesh.store is not None and \
                mesh.process_id == 0:
            mesh.publish_stop()
        for liaison in (self._gang, self._gang_follower):
            if liaison is not None:
                (getattr(liaison, "close", None) or liaison.stop)()

    def start(self) -> None:
        self._started = True
        self._supervisor.start()
        if self._gang is not None:
            threading.Thread(target=self._liaison_loop,
                             name="gang-liaison", daemon=True).start()

    def _supervise(self) -> None:
        """Engine-thread supervisor: start _loop, and when a LETHAL
        error kills it (something the per-tick recovery cannot catch),
        quarantine the dead engine's in-flight work — no engine is
        running between generations, so touching srv here is safe —
        and restart with exponential backoff, up to
        max_engine_restarts before giving up (/healthz then goes
        red: this thread's death is the 'restarts exhausted' signal
        healthy() reads)."""
        backoff = self._restart_backoff_s
        while True:
            self._thread.start()
            wedged = self._join_or_watchdog()
            # Engine observed dead (or its wedged generation
            # abandoned): the serialized engine->supervisor handover.
            self._adopt_ownership()
            if self._stop.is_set():
                return
            if wedged:
                self._stats["wedge_escalations"] += 1
            if self._stats["engine_restarts"] >= self._max_engine_restarts:
                self._stats["last_error"] = (
                    f"engine thread died; {self._max_engine_restarts} "
                    f"restarts exhausted")
                # Refuse-new-work BEFORE failing the backlog: with no
                # engine left, a later submit() must 503 immediately —
                # an enqueue into a never-drained queue would park its
                # handler for the full HTTP timeout. Sticky: a dead
                # engine can never be undrained back into service.
                self._drain_sticky = True
                self._draining.set()
                with self._on_device():
                    self._fail_all("engine dead (restarts exhausted)")
                return
            self._stats["engine_restarts"] += 1
            try:
                with self._on_device():
                    self._quarantine_inflight(
                        "engine tick wedged; hard restart" if wedged
                        else "engine thread restarted")
                    self._recover_mesh_after_crash()
            except Exception as e:
                # The supervisor's own recovery work hit the corrupted
                # state that killed the engine: do NOT die silently
                # with the backlog parked — refuse new work (sticky)
                # and fail everything fast, then go red.
                self._stats["last_error"] = f"supervisor recovery: {e}"
                self._drain_sticky = True
                self._draining.set()
                with self._on_device():
                    self._fail_all(f"engine dead (recovery failed: {e})")
                return
            if self._stop.wait(backoff):
                return
            backoff *= 2
            self._engine_gen += 1
            self._thread = threading.Thread(
                target=self._loop, args=(self._engine_gen,),
                name=f"engine-{self._engine_gen}", daemon=True)

    def _join_or_watchdog(self) -> bool:
        """Wait for the engine thread to die — or, with
        --tick-wedge-ms armed, catch it WEDGED first: a tick stuck
        past the bound is escalated to a hard restart by
        bumping the engine generation, which supersedes the stuck
        thread (Python cannot kill a thread, but it can make one
        irrelevant: the zombie aborts at its next superseded seam).
        Before the restart path touches the slot server, the zombie
        is JOINED with a bounded grace — a bounded hang (the chaos
        ``hang`` kind, a slow compile that tripped the bound) exits
        on its own and the quarantine runs with no concurrency; only
        a permanently hung thread (a dead device call that never
        returns) falls through to best-effort after the grace, where
        crash-only recovery (the journal) is the real remedy anyway.
        Returns True when the exit was a wedge escalation."""
        if not self._tick_wedge_ms:
            self._thread.join()
            return False
        poll_s = max(0.01, self._tick_wedge_ms / 4e3)
        while True:
            self._thread.join(timeout=poll_s)
            if not self._thread.is_alive():
                return False
            if self._stop.is_set():
                self._thread.join()
                return False
            t0 = self._tick_started
            if t0 is not None and \
                    (time.monotonic() - t0) * 1e3 > self._tick_wedge_ms:
                self._engine_gen += 1       # supersede the wedged thread
                self._tick_started = None   # its stale t0 must not
                self._stats["last_error"] = (  # re-trip the watchdog
                    f"tick wedged past {self._tick_wedge_ms:g} ms; "
                    f"hard engine restart")
                grace_s = max(5.0, 10.0 * self._tick_wedge_ms / 1e3)
                self._thread.join(timeout=grace_s)
                return True

    def stop(self) -> None:
        """Stop the engine: every thread it started (the supervisor and
        the engine thread it runs) is joined within ``STOP_JOIN_S`` in
        all. A thread still alive after that is wedged: stop() says so
        on stderr and in ``/stats`` ``last_error``, leaves the slot
        server to it, and ``live_threads()`` names it — so a caller
        never builds the next engine over a live one unknowingly."""
        self._stop.set()
        if not self._started:               # never started: nothing to
            with self._on_device():         # join, just drain
                self._fail_all("server shutting down")
            self._stop_followers()
            self._close_journal()
            return
        timeout_s = STOP_JOIN_S
        deadline = time.monotonic() + timeout_s
        self._supervisor.join(timeout=timeout_s)
        # The supervisor exits once the engine thread it last started
        # is observed dead, but a restart in flight can hand over a
        # newer one: join whichever is current, within what is left.
        self._thread.join(timeout=max(0.0, deadline - time.monotonic()))
        self._adopt_ownership()
        alive = self.live_threads()
        if alive:
            # Engine is wedged mid-step: do NOT touch srv/_active from
            # this thread (two threads mutating the slot server's host
            # state can double-free pool blocks — silent KV reuse).
            # Fail only the queue; active handlers hit their timeout.
            msg = (f"stop: {', '.join(alive)} still running after "
                   f"{timeout_s:g} s (wedged)")
            self._stats["last_error"] = msg
            print(f"tpushare-torch-serve: {msg}", file=sys.stderr,
                  flush=True)
            self._drain_pending("server shutting down")
            self._close_journal()
            return
        # Engine is down: fail everything so no handler thread sits on
        # done.wait() until its HTTP timeout. An unfetched overlapped
        # dispatch dies with it (counted — its requests fail below).
        self._flush_pipeline()
        with self._on_device():
            self._fail_all("server shutting down")
        self._stop_followers()
        self._close_journal()

    def live_threads(self) -> List[str]:
        """Names of the threads this engine started that are still
        alive (empty once stop() has joined them)."""
        return [t.name for t in (self._supervisor, self._thread)
                if t.is_alive()]

    def _close_journal(self) -> None:
        """Flush + close after the final terminal records (a clean
        shutdown's journal replays to an all-terminal state — the
        next boot recovers a dedupe window and zero open requests)."""
        if self._journal is not None:
            batches, self._jrnl_tick = self._jrnl_tick, {}
            for req, toks in batches.items():
                self._journal.append({
                    "k": "TOKENS", "id": req.request_id,
                    "s": len(req.tokens) - len(toks), "t": toks})
            self._journal.close()

    def healthy(self) -> bool:
        """Engine alive, or dead-with-restarts-remaining (the
        supervisor will bring it back — kubelet liveness must not kill
        the pod during a recoverable restart window)."""
        if self._thread.is_alive():
            return True
        return self._supervisor.is_alive() and not self._stop.is_set()

    def ready(self) -> bool:
        """READINESS, distinct from healthy() (liveness): True only
        when the engine is live AND accepting new work. A draining or
        restarting replica is healthy-but-not-ready — the router and
        the k8s readiness probe must stop routing to it while nothing
        kills it mid-drain. The single /healthz bit used to conflate
        the two; /readyz serves this predicate."""
        return self.healthy() and self.state() == "running"

    def prefix_keys(self) -> Dict[str, Any]:
        """Prefix-cache gossip for the front door: the hex chain keys
        this replica's pool currently holds (published OR live — a
        referenced block's chain is just as hittable on a follow-up
        admit as a parked one). Dense-row families have no block pool:
        ``keys`` is null there, NOT [] — the same null-not-zero
        contract as the pool counters, so the router reads "no prefix
        plane" instead of "empty prefix plane" and skips affinity for
        that replica rather than starving it.

        Reading the index from a handler thread races the engine's
        mutations; the dict is small and insertion-only between
        evictions, so a snapshot retry is enough (a momentarily stale
        gossip only costs one routing hit)."""
        if not self._has_pool:
            return {"kv": self.kv, "block_size": None, "keys": None}
        cache = self.srv.cache
        for _ in range(3):
            try:
                keys = [k.hex() for k in list(cache.index)]
                break
            except RuntimeError:        # resized mid-iteration
                continue
        else:
            keys = []
        if self._host_tier is not None:
            # Host-tier chains gossip too: the router may send affinity
            # (and siblings migration pulls) for chains only the tier
            # holds; admission promotes them back on the hit.
            dev = set(keys)
            keys += [k for k in self._host_tier.keys_hex()
                     if k not in dev]
        return {"kv": self.kv, "block_size": cache.block_size,
                "keys": keys}

    # -- host tier: block serving and migration ------------------------
    def _engine_call(self, fn, timeout_s: float = 30.0):
        """Run ``fn`` on the engine thread between ticks (inside
        ``_on_device()``) and return its result, or raise TimeoutError.
        Before the engine starts the caller runs it itself: nothing else
        touches the server then."""
        if not self._started:
            with self._on_device():
                return fn()
        box: Dict[str, Any] = {}
        done = threading.Event()
        self._engine_calls.put((fn, box, done))
        if not done.wait(timeout_s):
            raise TimeoutError("engine thread did not serve the call")
        if "error" in box:
            raise box["error"]
        return box["out"]

    def _serve_engine_calls(self) -> None:
        """Serve every queued ``_engine_call`` (engine thread, between
        ticks). A failing call answers its caller; the tick goes on."""
        while True:
            try:
                fn, box, done = self._engine_calls.get_nowait()
            except queue.Empty:
                return
            try:
                box["out"] = fn()
            except Exception as e:          # noqa: BLE001 — answered
                box["error"] = e
            done.set()

    def _read_pool_blocks(self, keys: List[bytes]):
        """Engine thread: copy the device-resident published blocks of
        ``keys`` to host memory — one gather per pool leaf and one
        asynchronous copy into page-locked memory on a card. Returns
        ({key: {field: host tensor}}, the copy's CUDA event or None).
        Keys the pool no longer holds are omitted."""
        from tpushare_torch.models.paged import _row_pairs
        cache = self.srv.cache
        found = [(k, cache.index[k]) for k in keys if k in cache.index]
        if not found:
            return {}, None
        ids = torch.tensor([b for _, b in found], device=self.device)
        cuda = self.device.type == "cuda"
        host, event = {}, None
        for pf, _ in _row_pairs(cache.pool_k_scale is not None):
            g = getattr(cache, pf).index_select(1, ids).transpose(0, 1)
            dst = torch.empty(g.shape, dtype=g.dtype, pin_memory=cuda)
            dst.copy_(g, non_blocking=True)
            host[pf] = dst
        if cuda:
            event = torch.cuda.Event()
            event.record()
        return ({k: {pf: t[i] for pf, t in host.items()}
                 for i, (k, _) in enumerate(found)}, event)

    def kv_blocks(self, keys_hex: List[str]) -> Dict[str, Any]:
        """Raw KV block payloads by chain digest — the replica-to-replica
        migration SOURCE (GET /kv/blocks). Tier-resident blocks are
        answered from host memory (a private copy); device-resident
        published blocks are copied by the engine thread between ticks
        (``_engine_call``): a handler never reads a pool tensor. Missing
        or raced keys are OMITTED — a partial answer is the gossip
        staleness contract: the puller lands the contiguous prefix it
        got and recomputes the rest."""
        if not self._has_pool:
            return {"block_size": None, "blocks": {}}
        datas: Dict[str, Any] = {}
        want: List[bytes] = []
        for kh in keys_hex:
            try:
                key = bytes.fromhex(kh)
            except ValueError:
                continue
            data = (self._host_tier.copy_out(key)
                    if self._host_tier is not None else None)
            if data is None:
                want.append(key)
            else:
                datas[kh] = data
        if want:
            try:
                dev, event = self._engine_call(
                    lambda: self._read_pool_blocks(want))
            except Exception:               # noqa: BLE001 — omitted
                dev, event = {}, None
            if event is not None:
                event.synchronize()
            for key, data in dev.items():
                datas[key.hex()] = data
        out: Dict[str, Any] = {}
        for kh in keys_hex:
            if kh in datas:
                out[kh] = {pf: _wire_leaf(t) for pf, t in datas[kh].items()}
        return {"block_size": self.srv.cache.block_size, "blocks": out}

    def _land_migrated(self, items, tenant: Optional[str]):
        """Engine thread: copy decoded migrated blocks into tier slots
        (a contiguous prefix only). Returns (landed, bytes)."""
        from tpushare_torch.models.paged import host_arena
        tier = self._host_tier
        arena = host_arena(self.srv.cache)
        landed = moved = 0
        for key, data in items:
            slot = arena.acquire()
            if slot is None:
                break
            arena.wait_on_host(slot)
            payload = arena.payload(slot)
            for pf, t in data.items():
                payload[pf].copy_(t)
            if not tier.put(key, payload, tenant=tenant,
                            tokens=self.srv.cache.block_size,
                            kind="migrate"):
                arena.release(slot)
                break
            landed += 1
            moved += arena.block_bytes
        return landed, moved

    def kv_migrate(self, source_url: str, keys_hex: List[str],
                   tenant: Optional[str] = None) -> Dict[str, Any]:
        """Pull published chain blocks from a sibling replica into the
        host tier (POST /kv/migrate). The crossover estimator's ``net``
        channel decides first (bytes-to-move vs tokens-to-prefill at
        measured rates); payloads are validated leaf by leaf against
        this engine's OWN pool shapes and dtypes; only a CONTIGUOUS
        chain prefix lands, on the engine thread. Every failure —
        refusal, transport error, stale sibling, malformed leaf —
        degrades to local recompute."""
        if self._host_tier is None:
            return {"migrated": 0, "decision": "no_tier"}
        import http.client
        import urllib.parse

        from tpushare_torch.models.paged import host_arena
        cache = self.srv.cache
        arena = host_arena(cache)
        est = self._host_tier.estimator
        if est.decide("net", arena.block_bytes * len(keys_hex),
                      cache.block_size * len(keys_hex)) == "recompute":
            return {"migrated": 0, "decision": "recompute",
                    "requested": len(keys_hex)}
        u = urllib.parse.urlsplit(source_url)
        t0 = time.perf_counter()
        try:
            conn = http.client.HTTPConnection(u.hostname, u.port or 80,
                                              timeout=10.0)
            try:
                conn.request("GET",
                             "/kv/blocks?keys=" + ",".join(keys_hex))
                resp = conn.getresponse()
                if resp.status != 200:
                    raise OSError(f"source answered {resp.status}")
                payload = json.loads(resp.read())
            finally:
                conn.close()
        except Exception as e:              # noqa: BLE001 — clean miss
            return {"migrated": 0, "decision": "transfer",
                    "requested": len(keys_hex), "error": str(e)}
        dt = time.perf_counter() - t0
        if payload.get("block_size") != cache.block_size:
            return {"migrated": 0, "decision": "transfer",
                    "requested": len(keys_hex),
                    "error": "block_size mismatch"}
        blocks = payload.get("blocks") or {}
        items = []
        for kh in keys_hex:
            data = _unwire_block(blocks.get(kh), arena.layout)
            if data is None:
                break                       # contiguous prefix only
            try:
                key = bytes.fromhex(kh)
            except ValueError:
                break
            items.append((key, data))
        landed = moved = 0
        if items:
            try:
                landed, moved = self._engine_call(
                    lambda: self._land_migrated(items, tenant))
            except Exception as e:          # noqa: BLE001 — clean miss
                return {"migrated": 0, "decision": "transfer",
                        "requested": len(keys_hex), "error": str(e)}
        if moved:
            est.observe_transfer("net", moved, dt)
        return {"migrated": landed, "decision": "transfer",
                "requested": len(keys_hex)}

    def state(self) -> str:
        """running | draining | restarting | shutting_down | dead — a
        wedged/crashed engine must not report ok just because a
        shutdown was requested. Draining keeps /healthz 200 (liveness
        must not kill a pod mid-drain); readiness is the 503s submit()
        answers. Restarting: the engine thread died and the supervisor
        is bringing it back (still 200)."""
        if self._thread.is_alive():
            if self._stop.is_set():
                return "shutting_down"
            return "draining" if self._draining.is_set() else "running"
        if self._stop.is_set():
            return "shutting_down"
        if self._supervisor.is_alive():
            return "restarting"
        return "dead"

    def _fail_all(self, msg: str, include_pending: bool = True) -> None:
        """Fail in-flight work; with ``include_pending`` also the
        queue/held backlog. The engine-error recovery path passes
        False: queued requests were never touched by the failed step,
        so the recovered engine serves them — failing them raced a
        just-submitted request into the previous request's error.
        Shutdown keeps True: no engine will ever serve that queue."""
        for store in (self._active, self._admitting):
            for slot, req in list(store.items()):
                req.error = msg
                req.finish()
                self._safe_evict(slot)
            store.clear()
        if include_pending:
            self._drain_pending(msg)

    def _safe_evict(self, slot: int) -> None:
        """Best-effort evict on a recovery path — but never silent: a
        failed evict leaks blocks, so it is counted and recorded."""
        try:
            self.srv.evict(slot)
        except Exception as e:
            self._stats["evict_errors"] += 1
            self._stats["last_error"] = f"evict({slot}): {e}"

    def _drain_pending(self, msg: str) -> None:
        for req in self._sched.drain() + self._quota_parked:
            req.error = msg
            req.finish()
        self._quota_parked = []
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                break
            req.error = msg
            req.finish()

    def active_count(self) -> int:
        with self._swap_lock:
            srv = self.srv
            return int(srv.active.sum()) if srv is not None else 0

    @property
    def default_tier(self) -> str:
        """Tier for requests that name none (--default-tier)."""
        return self._sched.default_tier

    @property
    def tier_specs(self):
        """The tier table THIS engine schedules by (custom
        ``tier_specs`` or the built-in three) — the handler validates
        request tier names against it, so the HTTP vocabulary always
        matches the scheduler's."""
        return self._sched.specs

    def stats(self) -> Dict[str, Any]:
        """The /stats surface: the reference engine's keys, with its
        nulls where a plane does not exist (null-not-zero: no pool, no
        mesh, no journal, no host tier). Every value is a host mirror or
        a host counter — a handler thread never reads a device tensor
        (the engine thread mutates them in place)."""
        with self._swap_lock:
            return self._stats_locked()

    def _stats_locked(self) -> Dict[str, Any]:
        from tpushare_torch.utils.profiling import \
            gap_percentiles as _gap_percentiles
        srv = self.srv
        if srv is None:                 # a failed rebuild: drained
            out = dict(self._stats)
            out.update(self._mesh_stats())
            return out
        jst = (self._journal.stats()
               if self._journal is not None else None)
        out = dict(self._stats)
        out.update({
            "active_slots": self.active_count(),
            "admitting_slots": len(self._admitting),
            "n_slots": srv.cache.n_slots,
            "model_family": self.model_family,
            "kv": self.kv,
            # Router-scoring surface: queue_depth counts
            # accepted-not-yet-admitted work; admissions_in_flight is
            # the chunked-prefill count (admitting_slots its alias).
            "queue_depth": (self._pending.qsize() + self._sched.backlog()
                            + len(self._quota_parked)),
            "admissions_in_flight": len(self._admitting),
            # Multi-tenant SLO surface: per-tier fairness + deadline
            # counters, backlog by tier, the default tier, and the
            # per-tenant KV-block quota ledger (null = unquota'd pool).
            "default_tier": self._sched.default_tier,
            "per_tier": self._tier_stats.snapshot(),
            "queue_by_tier": self._sched.backlog_by_tier(),
            "quota_parked": len(self._quota_parked),
            "tenants": (self._kv_quota.snapshot()
                        if self._kv_quota is not None else None),
            "uptime_s": round(time.monotonic() - self._engine_t0, 1),
            "prefix_hit_tokens": srv.prefix_hit_tokens,
            "prefix_prompt_tokens": srv.prefix_prompt_tokens,
            # Target-weight-stream forwards per work tick: 1.0 is the
            # fused-tick invariant.
            "forwards_per_tick": (
                round(out["model_forwards"] / out["work_ticks"], 3)
                if out["work_ticks"] else None),
            # device_fetches counts the device->host transfers made
            # INSIDE work ticks (deltas of the server's raw counter
            # around each tick's dispatch), so fetches_per_tick <= 1.0
            # IS the one-fetch invariant.
            "fetches_per_tick": (
                round(out["device_fetches"] / out["work_ticks"], 3)
                if out["work_ticks"] else None),
            # Failure-domain recovery surface.
            "chaos_active": self._chaos.active,
            "chaos_spec": self._chaos.spec_summary(),
            "chaos_fired": (self._chaos.fired_snapshot()
                            if self._chaos.active else None),
            "tick_deadline_ms": self._tick_deadline_ms,
            "tick_wedge_ms": self._tick_wedge_ms,
            # Process failure domain: the journal's durability counters
            # (null when journaling is off).
            "journal": jst,
            "journal_bytes": (jst["journal_bytes"] if jst else None),
            "journal_fsync_ms": (jst["journal_fsync_ms"] if jst
                                 else None),
            # Live wedge signal: how long the CURRENT tick has been
            # running (null between ticks).
            "tick_in_flight_ms": (
                round((time.monotonic() - t0) * 1e3, 1)
                if (t0 := self._tick_started) is not None else None),
            # Overlapped tick pipeline (null-not-0 in serial mode).
            "overlap_enabled": self._overlap_tick,
            "pipeline_flushes": (self._pipeline_flushes
                                 if self._overlap_tick else None),
            "host_gap_ms": (_gap_percentiles(list(self._host_gap_ms))
                            if self._overlap_tick else None),
            # Host KV offload tier: null-not-0 when none is configured
            # (no offload plane, not an idle one); the nested crossover
            # block cites every input of the transfer-vs-recompute
            # policy (measured channel rates, bytes, tokens, decisions).
            "host_tier": (self._host_tier.snapshot()
                          if self._host_tier is not None else None),
            "host_prefetch_errors": (self._prefetch_errors
                                     if self._host_tier is not None
                                     else None),
        })
        out.update(self._mesh_stats())
        if self._has_pool:
            # Host mirrors only: the free list, the LRU and the table.
            n_total = int(srv.cache.pool_k.shape[1])    # static shape
            allocatable = len(srv.cache.free) + len(srv.cache.lru)
            out.update({
                "free_blocks": len(srv.cache.free),
                "reclaimable_blocks": len(srv.cache.lru),
                "live_blocks": srv.cache.live_blocks(),
                # Fraction of the pool an admission could claim right
                # now (free + zero-ref reclaimable over total): the
                # router's pool-pressure signal and the /scale
                # advisory's exhaustion input.
                "pool_free_frac": (round(allocatable / n_total, 3)
                                   if n_total else None),
            })
        else:
            # Dense KV rows: no pool exists. Null (not 0!) so an
            # autoscaler keyed on pool exhaustion never reads an idle
            # dense-row server as permanently exhausted — and the
            # router's load metric reads null pool_free_frac as
            # neutral pressure, never as "exhausted".
            out.update({"free_blocks": None,
                        "reclaimable_blocks": None,
                        "live_blocks": None,
                        "pool_free_frac": None})
        if srv.speculative:
            # Mean tokens per (slot, round) in [1, gamma×horizon+1] is
            # the live acceptance signal: 1.0 = speculation buying
            # nothing, the ceiling = every draft accepted. Normalized
            # per slot-round, NOT per engine step — the step batches
            # all active slots, which would conflate concurrency with
            # acceptance. Slightly conservative on eos-truncated
            # rounds (accepted-then-discarded tokens aren't counted).
            # spec_rounds/spec_accept_rate come from the seam's own
            # counters (models/spec.py): rounds actually run and
            # accepted/proposed draft tokens — the accept rate is the
            # gamma×horizon tuning signal (high rate argues a longer
            # horizon; a rate collapsing with K argues a shorter one).
            rate = srv.spec_accept_rate()
            out["speculative"] = {
                "gamma": srv.gamma,
                "spec_horizon": srv.spec_horizon,
                "spec_rounds": srv.spec_rounds,
                "spec_accept_rate": (round(rate, 3)
                                     if rate is not None else None),
                "mean_tokens_per_round": round(
                    out["tokens_out"] / max(1, out["slot_rounds"]), 3),
            }
        if self._mesh is not None:
            # A sharded engine's own keys (an unsharded engine keeps
            # the reference's key set): the cards its ranks run on and
            # the collectives' transport.
            out["mesh_cards"] = self._mesh.n_cards
            out["grow_back_ms"] = self._mesh_stats_ms(self._grow_ms)
            out["mesh_transport"] = self._mesh.describe()
            out["mesh_broadcasts"] = getattr(srv, "broadcasts", None)
            # The digest of every server call's result on this rank
            # (rank 0's broadcaster or a follower's replay): equal on
            # every rank when their streams are.
            dig = getattr(srv, "digest", None) or getattr(
                self, "_follow_digest", None)
            out["mesh_digest"] = (dig.hexdigest() if dig is not None
                                  else None)
            # The digest restarts with every mesh generation: this
            # generation's number and every ended one's digest.
            out["mesh_generation"] = self._mesh.generation
            out["mesh_digests"] = {str(g): d for g, d in
                                   sorted(self._mesh_digests.items())}
            if self._mesh.process_id == 0:
                now = self._generation_report(
                    self._mesh, getattr(srv, "broadcasts", 0), end=False)
                now["digest"] = out["mesh_digest"]
                out["mesh_generations"] = self._generations + [now]
        return out

    @staticmethod
    def _mesh_stats_ms(ring: List[float]) -> Optional[Dict[str, float]]:
        """The last and p99 of a ring of milliseconds (null when empty)."""
        if not ring:
            return None
        srt = sorted(ring)
        return {"last": round(ring[-1], 1),
                "p99": round(srt[min(len(srt) - 1, int(0.99 * len(srt)))],
                             1)}

    def _mesh_stats(self) -> Dict[str, Any]:
        """The mesh and process-axis keys of /stats, with the
        reference's values and nulls: mesh_shape elides 1-sized axes
        ({} = a one-rank mesh, null = unsharded); the configured shape
        is the operator's, the current one shrinks on card loss;
        reshard_ms: the last and p99 of the rebuilds, shrinks and
        grow-backs alike (null before the first; a sharded engine adds
        ``grow_back_ms``, the grow-backs alone). The process axis is
        null without a process-aware mesh; ``gang`` is the liaison's
        view, null unless a GangLeader is attached."""
        conf, cur = self._mesh_configured, self._mesh
        ms = self._mesh_stats_ms
        return {
            "mesh_shape": _mesh_axes(cur),
            "num_devices": cur.size if cur is not None else 1,
            "mesh_shape_configured": _mesh_axes(conf),
            "mesh_shape_current": _mesh_axes(cur),
            "num_devices_configured": conf.size if conf is not None else 1,
            "healthy_devices": (sum(self._chip_health)
                                if self._chip_health is not None
                                else None),
            "degraded": self._degraded if conf is not None else None,
            "reshard_ms": ms(self._reshard_ms),
            "num_processes": (self._topo.num_processes
                              if self._topo is not None else None),
            "process_index": (self._topo.process_index
                              if self._topo is not None else None),
            "healthy_processes": (sum(self._host_health)
                                  if self._host_health is not None
                                  else None),
            "gang": (
                {"num_processes": self._gang.num_processes,
                 "heartbeat_timeout_s": self._gang.heartbeat_timeout_s,
                 "process_fetches": {
                     str(r): n for r, n in sorted(
                         self._gang.process_fetches().items())}}
                if self._gang is not None else None),
        }

    # -- engine side -------------------------------------------------
    def _intake_locked(self) -> None:
        """Drain the flat intake queue into the scheduler's per-tier
        queues (caller holds _pop_lock: a request must never be in
        neither container while drain()'s idle check looks). Bounded:
        once the scheduler holds max_queue requests the drain stops,
        so under a sustained flood the Queue fills and submit()'s 429
        backstop fires instead of the per-tier deques growing without
        bound (push_front re-admits stay exempt — they were accepted
        long ago)."""
        while self._sched.backlog() < self._max_queue:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            self._stats["requests"] += 1
            # The accepted-durably point: the request enters the
            # engine's own queues, so its ACCEPT must be replayable
            # from here on (re-queues and replays never re-ACCEPT).
            self._journal_accept(req)
            self._sched.push(req)

    def _try_admit(self) -> bool:
        with self._pop_lock:
            self._intake_locked()
            req = self._sched.pop()
            if req is None:
                return False
            # From here until placement the request lives in no
            # container; _popped keeps drain()'s idle check honest
            # across the prefill (handoff atomic under _pop_lock).
            self._popped = req
        try:
            if (int(self.srv.active.sum()) + self.srv.admitting_count
                    >= self.srv.cache.n_slots):
                # Slots full. Preempt-low-for-high: a higher-tier
                # arrival evicts the newest STRICTLY lower-tier slot
                # through the token-exact preemption+replay machinery
                # instead of queueing behind it; equal-or-higher
                # occupancy just waits its turn (front of its tier).
                if not self._preempt_one(below_rank=tier_rank(
                        req.tier, self._sched.specs)):
                    self._sched.push_front(req)
                    return False
            return self._admit_popped(req)
        except Exception as e:
            # A device/runtime failure mid-admission (a kernel or CUDA
            # error out of a prefill chunk or the first token fetch, an
            # injected admit fault). The popped
            # request may live in no container — losing it would park
            # its handler until the HTTP timeout — or may have been
            # registered (and its slot activated) before the failure:
            # deregister + evict first, or the replay would leave a
            # permanently-active server slot (or answer the request
            # from two slots at once). Then reap whatever slot the
            # server still holds for it (blocks must not leak).
            self._stats["engine_errors"] += 1
            self._stats["last_error"] = str(e)
            if self._is_mesh_fault(e):
                # A sharded admission dispatch died (a card or a peer
                # lost at prefill): flag it so the tick's admission
                # loop stops and reshards before the replayed request
                # re-pops onto the same broken placement.
                self._mesh_fault = f"admit mesh fault: {e}"
            for store in (self._active, self._admitting):
                for slot, r in list(store.items()):
                    if r is req:
                        store.pop(slot)
                        self._safe_evict(slot)
            if not req.done.is_set():
                self._replay_or_503(req, f"admit error: {e}")
            self._reap_orphan_slots()
            # The evictions above refunded this tenant's KV-block
            # charges — same contract as completion/preemption/
            # quarantine: a refund unparks, or a ceiling-parked
            # request whose tenant has nothing left in flight waits
            # until shutdown.
            self._unpark_tenant(req.tenant)
            return True
        finally:
            # Under _pop_lock like every other _popped store: a bare
            # clear here could race drain()'s pop-check-idle sequence
            # into reading "nothing in flight" mid-handoff.
            with self._pop_lock:
                self._popped = None

    def _admit_popped(self, req: _Request) -> bool:
        srv = self.srv
        if req.cancelled:               # client gave up while queued
            req.finish()
            return True
        chunked = (self._prefill_chunk is not None
                   and len(req.prompt) > self._prefill_chunk)
        self._fault_admit()
        # The tenant rides into the paged server's quota ledger; the
        # dense-row families have no block pool (and no tenant param).
        tkw = {"tenant": req.tenant} if self._has_pool else {}
        try:
            if chunked:
                slot = srv.admit_start(
                    np.asarray(req.prompt, np.int64),
                    adapter=req.adapter,
                    chunk_tokens=self._prefill_chunk, **tkw)
            else:
                slot = srv.admit(np.asarray(req.prompt, np.int64),
                                 adapter=req.adapter, **tkw)
        except ValueError as e:         # permanently invalid (prompt
            req.error = str(e)          # exceeds capacity, bad adapter
            req.status = 400
            self._stats["rejected"] += 1
            req.finish()
            return True
        except self._quota_exceeded as e:
            # Tier-aware quota verdict, caught BEFORE its PoolExhausted
            # parent. "ceiling": the tenant's own burst cap — with none
            # of its work in flight nothing will ever refund it, so
            # answer 429 (the client's quota, not the fleet's
            # capacity); with its work in flight, hold until its own
            # completions refund blocks. "reserve": pool-wide pressure
            # (another tenant's floor) — hold, and let the tier ladder
            # preempt a strictly lower-tier victim to cure it.
            if e.kind == "ceiling":
                mine = any(r.tenant == req.tenant for r in
                           list(self._active.values())
                           + list(self._admitting.values()))
                if not mine:
                    req.error = str(e)
                    req.status = 429
                    self._stats["rejected"] += 1
                    req.finish()
                    return True
                # PARK, don't re-queue: only this tenant's own
                # refunds can cure a ceiling hold, and back at the
                # front of its tier the request would freeze every
                # other tenant's admissions (strict-priority keeps an
                # at-risk head first in every pop, and one held head
                # ends the tick's admission loop). Parked requests
                # leave the rotation entirely and re-enter at their
                # tier front the moment a slot of THIS tenant frees
                # (_unpark_tenant). True: the head moved aside —
                # other requests admit this same tick.
                self._quota_parked.append(req)
                return True
            # "reserve": first rule out the hold that can never be
            # cured — even a fully idle pool still owes the OTHER
            # tenants their full floors, so a fresh need beyond
            # (usable blocks - those floors) is permanent for this
            # deployment's quota table: answer 429 now instead of
            # pinning the admission loop forever (an at-risk
            # interactive head would re-pop every tick and starve
            # every other tenant's admissions).
            need = getattr(e, "need", None)
            usable = self.srv.cache.pool_k.shape[1] - 1
            if (need is not None and need >
                    self._kv_quota.attainable_blocks(req.tenant,
                                                     usable)):
                req.error = (f"{e} (permanent: {need} fresh blocks "
                             f"exceed the pool minus other tenants' "
                             f"reserve floors)")
                req.status = 429
                self._stats["rejected"] += 1
                req.finish()
                return True
            return self._hold_or_preempt(req, reserve_for=req.tenant)
        except self._pool_exhausted as e:
            # Typed transient pressure ONLY (paged.PoolExhausted):
            # a broad RuntimeError catch here used to swallow genuine
            # device failures as "pool pressure" and hold the request
            # forever; those now propagate to _try_admit's
            # quarantine/replay handler.
            if not self.active_count() and not srv.admitting_count:
                # Nothing in flight will ever free blocks: the pool
                # simply cannot hold this prompt — permanent for this
                # deployment size.
                req.error = str(e)
                self._stats["rejected"] += 1
                req.finish()
                return True
            # Transient: pool/slot pressure from in-flight decodes.
            # Hold the request (front of its tier: it keeps its place)
            # and retry next tick — blocks free as generations
            # complete, and a strictly lower-tier victim may be
            # preempted to free them NOW; a 503 here would reject a
            # backlog admittable moments later.
            return self._hold_or_preempt(req)
        if chunked:
            req.cached_prefix = srv.last_cached_len
            self._seq += 1
            req.seq = self._seq
            self._admitting[slot] = req
            self._stats["chunked_admits"] += 1
            self._tier_stats.bump(req.tier, "admitted")
            return True
        req.cached_prefix = self.srv.last_cached_len
        self._seq += 1
        req.seq = self._seq
        self._tier_stats.bump(req.tier, "admitted")
        # The token sampled from the prompt's last logits is the first
        # emitted token (it is already the slot's pending last_token).
        first = int(self.srv.last_token[slot, 0])
        if self._tok_bad(first):
            # NaN logits at prefill (the sampler picked -1): same
            # slot-scoped failure domain as a poisoned decode tick.
            self._active[slot] = req
            self._quarantine_slot(slot, self._active,
                                  "NaN token (poisoned prefill)")
            return True
        self._emit(req, first)
        self._active[slot] = req
        self._maybe_finish(slot, first)
        return True

    def _hold_or_preempt(self, req: "_Request",
                         reserve_for: Optional[str] = None) -> bool:
        """Transient pressure hold, tier-aware: try to free capacity
        NOW by preempting the newest STRICTLY lower-tier victim
        (preempt-low-for-high through the token-exact machinery), then
        park the request at the front of its tier for the next tick.
        Equal-tier pressure just holds — same-tier traffic never
        churns itself. ``reserve_for`` (the held tenant, on a
        reserve-quota verdict) restricts victims to ones whose
        eviction actually raises that tenant's headroom."""
        self._preempt_one(below_rank=tier_rank(req.tier,
                                               self._sched.specs),
                          reserve_for=reserve_for)
        self._sched.push_front(req)
        return False

    def _emit(self, req: "_Request", tok: int) -> None:
        """Engine-side token emission: push + the tier's TTFT
        accounting on the request's FIRST token (replays carry their
        tokens, so their first push happened in an earlier life and
        the clock never restarts). After the liaison aborted the
        generation's NCCL communicators, a fetch the abort released
        carries no trustworthy token: the tick fails as a mesh fault
        before any emission."""
        if self._mesh_aborted:
            raise RuntimeError("NCCL communicators aborted: a peer host "
                               "was lost mid-collective")
        first = not req.tokens
        req.push(tok)
        self._note_emission(req, tok)
        if first:
            self._tier_stats.record_first_token(
                req.tier, (req.t_first - req.t_submit) * 1e3)

    def _preempt_one(self, below_rank: Optional[int] = None,
                     reserve_for: Optional[str] = None) -> bool:
        """Pool exhausted mid-step (or preempt-low-for-high with
        ``below_rank``): evict ONE victim instead of failing the whole
        batch (the vLLM recompute-preemption move). Victim = lowest
        tier first, newest admit within it (least work lost) — and
        when a quota'd tenant burst past its KV-block ceiling, its
        slots lose first (the burst is exactly what growth-time quota
        charging defers to this point). The victim's prompt is
        extended with the tokens generated so far and requeued at the
        front of its tier, so with prefix caching on the re-prefill is
        mostly cache hits and generation continues where it left off
        (_try_admit appends the re-admit's sampled token — the natural
        next token after the extended prompt)."""
        if not self._active:
            return False
        pool = self._active
        if self._kv_quota is not None:
            tenants = (self.srv.slot_tenants()
                       if hasattr(self.srv, "slot_tenants") else {})
            if reserve_for is not None:
                # Reserve-quota hold: only victims whose eviction
                # raises the held tenant's net headroom are worth
                # churning — the held tenant's own slots (their
                # refund shrinks its need side), or tenants strictly
                # over their own floor (freeing an at-or-under-floor
                # tenant's blocks grows its unmet floor by exactly
                # the freed amount: zero net). No eligible victim =
                # hold without preempting; completions cure it.
                pool = {s: r for s, r in pool.items()
                        if (t := tenants.get(s, r.tenant)) == reserve_for
                        or self._kv_quota.over_floor(t)}
                if not pool:
                    return False
            base = pool
            over = {s: r for s, r in pool.items()
                    if self._kv_quota.over_ceiling(
                        tenants.get(s, r.tenant))}
            if over:
                pool = over
        else:
            base = pool
        slot = choose_victim(pool, below_rank=below_rank,
                             specs=self._sched.specs)
        if slot is None and pool is not base:
            # Widen past the over-ceiling preference, but never past
            # the reserve-eligibility filter: a victim outside it
            # cannot cure the hold that asked for this preemption.
            slot = choose_victim(base, below_rank=below_rank,
                                 specs=self._sched.specs)
        if slot is None:
            return False
        req = self._active.pop(slot)
        self._safe_evict(slot)
        self._stats["preempted"] += 1
        self._tier_stats.bump(req.tier, "preempted")
        self._unpark_tenant(req.tenant)
        if req.cancelled:
            req.finish()
            return True
        req.fold_into_prompt()
        # Front of its tier: a preempted victim's blocks just freed,
        # and its partial work should resume before both
        # never-admitted held requests and its tier's queue.
        self._sched.push_front(req)
        return True

    def _unpark_tenant(self, tenant: str) -> None:
        """A slot of ``tenant`` just freed (completion, preemption,
        quarantine, cancelled reap) and refunded its KV-block charge:
        its ceiling-parked requests re-enter at the front of their
        tiers for the next admission pass (a still-over-ceiling
        retry just parks again — each retry costs one freed slot, so
        there is no spin)."""
        if not self._quota_parked:
            return
        mine = [r for r in self._quota_parked if r.tenant == tenant]
        if not mine:
            return
        self._quota_parked = [r for r in self._quota_parked
                              if r.tenant != tenant]
        for r in reversed(mine):        # reversed: order preserved
            self._sched.push_front(r)   # across the push_front stack

    def _finish_completed(self, req: "_Request") -> None:
        """Terminal SUCCESS transition: the flat counter, the tier's
        completion/latency accounting (cancelled reaps complete the
        slot but measure nothing — an abandoned stream's latency is
        the client's, not the engine's), and the handler wakeup."""
        self._stats["completed"] += 1
        if not req.cancelled and req.t_first is not None:
            self._tier_stats.bump(req.tier, "tokens", len(req.tokens))
            self._tier_stats.record_completion(
                req.tier, len(req.tokens),
                (req.t_last - req.t_first) * 1e3)
        self._unpark_tenant(req.tenant)
        req.finish()

    def _maybe_finish(self, slot: int, tok: int) -> None:
        req = self._active.get(slot)
        if req is None:
            return
        if (req.cancelled
                or (req.eos is not None and tok == req.eos)
                or len(req.tokens) >= req.max_tokens):
            # _safe_evict: a failed evict on the completion path must
            # count a leak, not raise past req.finish() — the request
            # IS complete, and letting the exception reach the
            # quarantine path would replay (and re-answer) it.
            self._safe_evict(slot)
            del self._active[slot]
            self._finish_completed(req)

    def _loop(self, gen: int = 0) -> None:
        self._adopt_ownership()
        with self._on_device():
            while not self._stop.is_set() and gen == self._engine_gen:
                self._loop_once(gen)

    def _check_superseded(self, gen: Optional[int]) -> None:
        """Abort a superseded (wedge-escalated) thread's tick at a
        safe seam — before it can mutate the slot server or emit into
        requests the new generation already replayed."""
        if gen is not None and gen != self._engine_gen:
            raise _EngineSuperseded()

    def _fire_kill_chaos(self) -> None:
        """process.kill chaos point: a fired ``raise`` SIGKILLs this
        process — the crash-recovery storm's deterministic kill -9.
        Nothing is flushed first: the 'crash' leaves exactly what a
        real SIGKILL leaves (whatever already reached the OS)."""
        try:
            self._fault_kill()
        except InjectedFault:
            os.kill(os.getpid(), signal.SIGKILL)

    def _loop_once(self, gen: Optional[int] = None) -> None:
        """One supervised engine iteration: tick, per-tick failure
        recovery, deadline accounting. Split from _loop so tests can
        drive the recovery machinery synchronously."""
        self._fire_kill_chaos()
        if self.srv is None:
            # A rebuild failed and left no server: the replica is
            # drained sticky and its backlog failed.
            time.sleep(self._idle_sleep_s)
            return
        self._serve_engine_calls()
        t0 = time.monotonic()
        self._stats["ticks"] += 1
        # Published BEFORE the tick runs: a genuinely wedged tick
        # never reaches the post-hoc breach accounting below, so
        # /stats' tick_in_flight_ms (read from this timestamp by the
        # handler thread) is the only live signal of the wedge — and
        # the wedge watchdog's escalation trigger.
        self._tick_started = t0
        try:
            self._tick(gen)
        except _EngineSuperseded:
            # Escalated away mid-wedge: the new generation owns every
            # piece of state now — touch nothing, not even the
            # accounting, and let _loop's generation check exit.
            return
        except Exception as e:              # noqa: BLE001 — the engine
            # must survive anything step()/admit() can raise: the
            # tick is the failure domain, so every in-flight
            # slot's device state is suspect — quarantine them all
            # and REPLAY their requests (token-exact re-admission)
            # instead of 503ing work a transient fault never
            # corrupted. A dead engine thread with a happy
            # /healthz is the one unacceptable state (lethal
            # BaseExceptions escape to the supervisor, which
            # restarts the thread).
            self._stats["engine_errors"] += 1
            self._stats["last_error"] = str(e)
            if self._device_lost(e):
                # A sticky CUDA error fails every replay on this card:
                # hand the thread's death to the supervisor, whose
                # restart budget ends it red and bounded, never as a
                # quarantine-replay loop.
                raise _DeviceLost(str(e)) from e
            if self._is_mesh_fault(e):
                # A card or a peer rank lost under a sharded dispatch:
                # the MESH is the failure domain — degrade-and-replay
                # (quarantine rides inside) instead of replaying onto
                # the same broken placement until replays exhaust.
                self._reshard(f"mesh fault: {e}")
            else:
                self._quarantine_inflight(f"engine error: {e}")
        finally:
            if gen is None or gen == self._engine_gen:
                # A superseded thread must not clobber the NEW
                # generation's in-flight timestamp or flush its
                # half-batched journal records.
                self._tick_started = None
                self._journal_tick_end()
            if self._tick_deadline_ms is not None:
                dt_ms = (time.monotonic() - t0) * 1e3
                if dt_ms > self._tick_deadline_ms:
                    self._stats["deadline_breaches"] += 1

    def _device_lost(self, e: BaseException) -> bool:
        """A CUDA error out of a tick whose context no longer runs work
        (an illegal address, a launch failure: the sticky class). A
        kernel wrapper's launch error or torch's own CUDA error is
        probed with one device synchronize; an error the card survived
        keeps the tick failure domain (quarantine and replay)."""
        if self.device.type != "cuda":
            return False
        cuda_error = getattr(torch, "AcceleratorError", ())
        if not (isinstance(e, cuda_error) or "CUDA error" in str(e)):
            return False
        try:
            torch.cuda.synchronize(self.device)
        except Exception:                   # noqa: BLE001 — the probe
            return True                     # IS the classification
        return False

    # -- failure-domain recovery -------------------------------------
    # -- mesh failure domain -------------------------------------------
    def _device_in_serving_mesh(self, device: int) -> bool:
        """Does the CURRENT serving mesh run on configured position
        ``device``?"""
        return self._positions is not None and device in self._positions

    def _is_mesh_fault(self, e: BaseException) -> bool:
        """Classify a tick failure: on a multi-rank engine, a flagged
        card- or host-health event, the injected chip failure, or a
        collective's transport error (a dead or departed peer: gloo's
        closed connection, an NCCL or store error) is a MESH fault and
        routes to degrade-and-replay; anything else keeps the tick
        domain (quarantine and replay on the same server)."""
        if self._mesh_configured is None or self._mesh_configured.size < 2:
            return False
        if self._mesh_fault is not None:
            return True
        from tpushare_torch.chaos import InjectedXlaRuntimeError
        if isinstance(e, (InjectedXlaRuntimeError, dist_errors())):
            return True
        return isinstance(e, RuntimeError) and any(
            w in str(e) for w in _TRANSPORT_WORDS)

    def _fire_chip_chaos(self) -> None:
        """mesh.chip_failure chaos point (multi-rank engines only): a
        fired ``raise`` flips the highest-positioned card the serving
        mesh still uses unhealthy and re-raises, so this tick dies with
        the fault and ``_loop_once`` reshards. Never the last healthy
        card: total loss is the drain path, driven by chip_event."""
        from tpushare_torch.chaos import InjectedXlaRuntimeError
        try:
            self._fault_chip()
        except InjectedXlaRuntimeError:
            healthy = [i for i, h in enumerate(self._chip_health)
                       if h and self._device_in_serving_mesh(i)]
            if len(healthy) <= 1 or sum(self._chip_health) <= 1:
                return
            victim = healthy[-1]
            self._chip_health[victim] = False
            self._mesh_fault = f"chip {victim} unhealthy (chaos)"
            raise

    def _fire_host_chaos(self) -> None:
        """host.loss chaos point (process-aware engines only): a fired
        ``raise`` takes one whole host dark. With a gang liaison the
        injection is heartbeat silence (``sever``): the loss must be
        detected by the liaison's timeout. Without one the host is
        marked down directly. Never rank 0's own host, never the last
        healthy one."""
        if self._topo is None or self._topo.num_processes < 2:
            return
        from tpushare_torch.chaos import InjectedXlaRuntimeError
        try:
            self._fault_host()
        except InjectedXlaRuntimeError:
            own = self._topo.process_index
            live = [r for r in range(self._topo.num_processes)
                    if self._host_health[r] and r != own]
            if self._gang is not None:
                seen = set(self._gang.seen_ranks())
                live = [r for r in live if r in seen]
            if not live or sum(self._host_health) <= 1:
                return
            victim = live[-1]
            if self._gang is not None:
                self._gang.sever(victim)
            else:
                self.host_event(victim, False)

    def _poll_gang(self) -> bool:
        """Translate liaison heartbeat verdicts into host events;
        True where a host was lost."""
        if self._gang is None:
            return False
        ev = self._gang.poll()
        for rank in ev["lost"]:
            self.host_event(rank, False)
        for rank in ev["rejoined"]:
            self.host_event(rank, True)
        return bool(ev["lost"])

    def _liaison_loop(self) -> None:
        """Rank 0 with a gang: poll the liaison while the engine thread
        may be blocked in a collective with the lost host's ranks; over
        NCCL, abort the generation's communicators so that collective
        ends with an error (gloo raises on a closed peer by itself)."""
        last_log = None
        while not self._stop.wait(0.1):
            try:
                lost = self._poll_gang()
            except Exception as e:      # noqa: BLE001 — keep watching
                # Never silent: over NCCL this loop is what ends a
                # collective blocked on a lost host. Count every failed
                # poll; print the first, then one per interval.
                self._liaison_errors += 1
                now = time.monotonic()
                if last_log is None or \
                        now - last_log >= LIAISON_LOG_INTERVAL_S:
                    last_log = now
                    print(f"tpushare-torch-serve: gang liaison poll "
                          f"failed ({self._liaison_errors} so far): "
                          f"{e!r}", file=sys.stderr, flush=True)
                continue
            mesh = self._mesh
            if lost and self._mesh_fault is not None and \
                    mesh is not None and mesh.transport == "nccl":
                self._mesh_aborted = True
                mesh.abort()

    def _mesh_preamble(self) -> bool:
        """The tick preamble of a sharded engine: chaos points, liaison
        verdicts, and a flagged fault resharded before any dispatch
        touches the dead card's slices. True when the tick resharded
        (the caller returns)."""
        if self._mesh_configured is None:
            return False
        self._fire_chip_chaos()
        self._fire_host_chaos()
        self._poll_gang()
        if self._mesh_fault is not None:
            self._flush_pipeline()
            self._reshard(self._mesh_fault)
            return True
        return False

    def _process_alive(self, pid: int) -> bool:
        """Is process ``pid`` taken for alive? Rank 0 always is; a lost
        host's processes are not, nor one that never freed its memory
        for a generation (until it stands by again)."""
        if pid == 0:
            return True
        if pid in self._presumed_dead:
            return False
        return (self._topo is None
                or self._host_health[self._topo.process_of(pid)])

    def _reshard(self, reason: str) -> None:
        """Degrade-and-replay, the mesh failure domain's recovery:

        1. quarantine every in-flight request (request state is host
           resident: prompt plus generated tokens), to replay
           token-exact;
        2. re-carve the largest healthy sub-mesh
           (``models/reshard.plan_reshard``);
        3. end the mesh generation and build the next one there: every
           rank drops its old server, frees its card's memory and
           rebuilds its slices from the ParamStore;
        4. bounded by max_reshards, after which the replica goes
           drained-sticky and its backlog fails fast.

        Engine thread only (the tick, ``_loop_once``'s classifier, or
        the supervisor between engine generations)."""
        t0 = time.monotonic()
        inflight = len(self._active) + len(self._admitting)
        if self._mesh.transport == "nccl" and self._mesh.size > 1:
            # This generation ends: abort its communicators before
            # anything waits on the card, where a collective may wait
            # on a dead peer; nothing fetched from here on is emitted.
            self._mesh_aborted = True
            self._mesh.abort()
        self._quarantine_inflight(reason)
        self._stats["replayed_on_reshard"] += inflight
        self._mesh_fault = None
        if self._stats["reshards"] >= self._max_reshards:
            self._drain_dead(f"{reason}: {self._max_reshards} reshard "
                             f"budget exhausted; replica drained")
            return
        from tpushare_torch.models.reshard import plan_reshard
        for _ in range(self._mesh_configured.size):
            plan = plan_reshard(self._mesh_configured, self._chip_health,
                                self._cfg, self._draft_cfg)
            if plan.mesh is None:
                self._drain_dead(
                    f"{reason}: no serving shape fits the "
                    f"{plan.n_healthy} surviving card(s); replica "
                    f"drained")
                return
            done = self._rebuild_on(plan)
            if done is True:
                break
            if done is False:
                self._drain_dead(self._stats["last_error"])
                return
            # A process the plan waited on never freed its memory: it
            # is taken for dead, and the next plan carves around it.
            for pid in done:
                self._chip_health[pid] = False
        else:
            self._drain_dead(f"{reason}: no generation formed")
            return
        self._stats["reshards"] += 1
        self._reshard_ms.append((time.monotonic() - t0) * 1e3)
        del self._reshard_ms[:-512]

    def _drain_dead(self, msg: str) -> None:
        """Nothing can serve here: drain sticky and fail the backlog
        fast (parked handlers must not wait out the HTTP timeout)."""
        self._stats["last_error"] = msg
        self._drain_sticky = True
        self._draining.set()
        self._fail_all(msg)

    def _rebuild_on(self, plan):
        """End the current mesh generation and serve the next one on
        ``plan``'s mesh: post the plan on the store (every follower
        learns of it there, even one whose peer died), retire the old
        server, drop it and free this card's memory, wait until every
        live process of the old generation freed its own, then form
        the new groups and build this rank's server by the factory
        from the ParamStore. Returns True on success, False where the
        build failed (no server is left: the caller drains), or the
        processes that never freed their memory (taken for dead; the
        caller re-plans around them)."""
        from tpushare_torch.parallel.control import ShardedServer
        cur = self._mesh
        nxt = cur.successor(plan.spec, plan.positions,
                            self._mesh_configured)
        nxt.publish([pid for pid in cur.members
                     if self._process_alive(pid)])
        old = self.srv
        calls = 0
        if isinstance(old, ShardedServer):
            old.retire(nxt.generation)
            self._mesh_digests[cur.generation] = old.digest.hexdigest()
            calls = old.broadcasts
        elif cur.control is not None and cur.rank == 0:
            # A generation whose build failed here: its followers wait
            # on its channel all the same.
            cur.control.send(("regen", nxt.generation))
        self._generations.append(self._generation_report(cur, calls))
        with self._swap_lock:
            self.srv = None
        old = None
        cur.abort()         # NCCL: before the sync that frees the card
        self._free_card_memory()
        cur.release()
        self._mesh = nxt
        deadline = time.monotonic() + RESHARD_ACK_S
        missing = nxt.missing_frees()
        while missing and time.monotonic() < deadline:
            self._poll_gang()
            dead = [p for p in missing if not self._process_alive(p)]
            if dead:
                # The liaison declared a host lost meanwhile: carve
                # around it now rather than at the deadline.
                missing = dead
                break
            time.sleep(0.005)
            missing = nxt.missing_frees()
        if missing:
            self._stats["last_error"] = (
                f"mesh generation {nxt.generation}: processes "
                f"{missing} never freed their memory")
            self._presumed_dead.update(missing)
            nxt.rank = None
            return list(missing)
        try:
            self.device = nxt.device
            with self._on_device():
                nxt.join()
                params, draft = self._param_store.load()
                quota = (KvQuota(self._tenant_quotas)
                         if self._tenant_quotas else None)
                srv = self._build_server(
                    params, ((draft, self._draft_cfg)
                             if draft is not None else None), nxt, quota)
        except Exception as e:          # noqa: BLE001 — no server left
            self._stats["engine_errors"] += 1
            self._stats["last_error"] = f"mesh rebuild failed: {e}"
            return False
        with self._swap_lock:
            self.srv = srv
        self._mesh_aborted = False
        self._kv_quota = quota
        self._positions = list(plan.positions)
        self._degraded = plan.degraded
        self._serving_plan = plan
        if all(self._chip_health[p] for p in self._positions):
            # A health event for a card this rebuild already left out
            # (the liaison's verdict on a host the plan carved around)
            # is no fault of the new mesh.
            self._mesh_fault = None
        # The old pool's ledger died with it: ceiling-parked requests
        # re-enter their tiers (the fresh pool owes nobody).
        for r in reversed(self._quota_parked):
            self._sched.push_front(r)
        self._quota_parked = []
        return True

    def _maybe_grow_back(self) -> bool:
        """Idle-tick grow-back: every card healthy again and the engine
        shrunk, and every process the configured mesh names alive and
        standing by — rebuild on the full configured mesh. Runs only
        with nothing in flight, so nothing replays. A process not yet
        standing by defers the grow to a later idle tick. A failed
        build rebuilds on the degraded plan that was serving (its
        slices fitted a moment ago), which serves on while an idle tick
        ``GROW_RETRY_S`` later tries the grow again; only where that
        rebuild fails too does the replica drain."""
        if (self._mesh_configured is None or not self._degraded
                or self._mesh_fault is not None
                or self._draining.is_set()
                or not all(self._chip_health)
                or time.monotonic() < self._grow_retry_at):
            return False
        conf, cur = self._mesh_configured, self._mesh
        absent = set(range(conf.size)) - set(cur.members)
        if not absent <= set(cur.ready_ids(conf.size)):
            return False
        self._presumed_dead -= absent
        from tpushare_torch.models.reshard import plan_reshard
        t0 = time.monotonic()
        plan = plan_reshard(conf, self._chip_health, self._cfg,
                            self._draft_cfg)
        serving = self._serving_plan
        done = self._rebuild_on(plan)
        if done is False:
            failed = self._stats["last_error"]
            done = self._rebuild_on(serving)
            if done is True:
                self._stats["last_error"] = f"grow-back: {failed}"
                self._grow_retry_at = time.monotonic() + GROW_RETRY_S
                return True
        if done is not True:
            if done is not False:
                for pid in done:
                    self._chip_health[pid] = False
                self._reshard("grow-back: a process never freed its "
                              "memory")
            else:
                self._drain_dead(self._stats["last_error"])
            return True
        self._stats["grow_backs"] += 1
        for ring in (self._reshard_ms, self._grow_ms):
            ring.append((time.monotonic() - t0) * 1e3)
            del ring[:-512]
        return True

    def _recover_mesh_after_crash(self) -> None:
        """Supervisor x mesh seam: a supervised restart must serve on
        the CURRENT healthy mesh, never over a dead card. Runs between
        engine generations (no engine thread alive)."""
        if self._mesh_configured is None or self._mesh_configured.size < 2:
            return
        if self._mesh_fault is not None:
            self._reshard(self._mesh_fault)
            return
        if any(not self._chip_health[p] for p in self._positions):
            self._reshard("engine restarted over a dead card")

    def _quarantine_inflight(self, msg: str) -> None:
        """Tick-level failure domain: evict EVERY in-flight slot and
        replay its request (the whole batch shared the failed forward,
        so no slot's device state is trustworthy). Replay is
        token-exact: the request re-admits at the queue front with
        prompt + already-generated tokens, and greedy decoding
        continues exactly where it left off.

        Pipeline contract: the in-flight overlapped dispatch is
        flushed FIRST (unfetched) — at a fault the pending tick is
        None by the time slots quarantine, so "in flight" is exactly
        the dispatched tick's slot set, never the next tick's picked
        set."""
        self._flush_pipeline()
        for store in (self._active, self._admitting):
            for slot in list(store):
                self._quarantine_slot(slot, store, msg)
        self._reap_orphan_slots()

    def _quarantine_slot(self, slot: int, store: Dict[int, "_Request"],
                         msg: str) -> None:
        """Slot-level quarantine: evict the slot (its KV is suspect),
        then replay-or-503 its request."""
        req = store.pop(slot)
        self._safe_evict(slot)
        self._stats["quarantines"] += 1
        self._tier_stats.bump(req.tier, "quarantined")
        self._unpark_tenant(req.tenant)
        self._replay_or_503(req, msg)

    def _replay_or_503(self, req: "_Request", msg: str) -> None:
        """Bounded replay: re-queue at the FRONT (held work precedes
        the queue) with the generated tokens folded into the prompt —
        re-admission prefills prompt+prefix, so the continuation is
        bit-identical to the fault-free run under greedy sampling.
        After max_replays quarantines the request 503s cleanly."""
        if req.cancelled:
            req.finish()
            return
        if req.replays >= self._max_replays:
            req.error = (f"{msg} (quarantined; {req.replays} replays "
                         f"exhausted)")
            req.status = 503
            req.finish()
            return
        req.replays += 1
        self._stats["replays"] += 1
        req.fold_into_prompt()
        # Front of its tier: replays carry their tokens and deadline
        # clock — the tier contract survives quarantine (the chaos
        # suite pins exactly this).
        self._sched.push_front(req)

    def _reap_orphan_slots(self) -> None:
        """A failed admission can leave the slot server holding state
        the engine never registered: chunked-admission state (and its
        reserved blocks) from an admit_step that raised mid-chunk, or
        a fully-ACTIVE slot from an admit() that succeeded right
        before a later step of the admission path failed. Reclaim
        both, or each fault leaks a prompt's worth of blocks — and an
        orphaned active slot would consume engine capacity forever."""
        for slot in getattr(self.srv, "admission_slots", []):
            if slot not in self._admitting and slot not in self._active:
                self._safe_evict(slot)
        for slot, on in enumerate(self.srv.active):
            if on and slot not in self._active \
                    and slot not in self._admitting:
                self._safe_evict(int(slot))

    def _tok_bad(self, tok: Any) -> bool:
        """A fetched token that is NaN (poisoned logits argmax), not
        integral, or out of vocabulary marks its slot's tick output as
        garbage — the host-visible signature of a corrupted forward."""
        try:
            ti = int(tok)
        except (TypeError, ValueError, OverflowError):
            return True
        return (tok != tok or ti != tok
                or not (0 <= ti < self.srv.cfg.vocab_size))

    def _reap_cancelled_admissions(self) -> None:
        """Drop cancelled (timed-out) in-flight admissions before any
        pick can spend a tick on them."""
        for slot in list(self._admitting):
            req = self._admitting[slot]
            if req.cancelled:
                del self._admitting[slot]
                self._safe_evict(slot)
                self._unpark_tenant(req.tenant)
                req.finish()

    def _pick_admission(self) -> Optional[int]:
        """The ONE admitting slot this tick advances, reaping
        cancelled admissions on the way; None when no admission is in
        flight. Tier-aware (slo.TickScheduler.pick_admission): an
        at-risk interactive admission always advances, otherwise
        tiers take weighted turns — oldest first within a tier, which
        is exactly the old oldest-first behavior when every admission
        shares one tier."""
        self._reap_cancelled_admissions()
        return self._sched.pick_admission(self._admitting)

    def _pick_admission_planned(self) -> Optional[int]:
        """Overlap-mode admission pick: commit the choice precomputed
        inside the last overlap window iff the admitting set is
        unchanged (slot+seq identity), else recompute fresh. Either
        way the committed rotation state matches what a fresh
        pick_admission would have left — the plan only moves the host
        arithmetic into the device window."""
        self._reap_cancelled_admissions()
        plan, self._next_pick_plan = self._next_pick_plan, None
        if plan is not None and plan["admitting"] == tuple(sorted(
                (s, r.seq) for s, r in self._admitting.items())):
            return self._sched.commit_admission(plan["choice"])
        return self._sched.pick_admission(self._admitting)

    def _plan_next_pick(self) -> None:
        """Precompute the NEXT tick's scheduling decisions inside this
        tick's overlap window — the host work the in-flight dispatch
        hides. Pure reads only: TickScheduler.peek / peek_admission
        and KvQuota.ledger_view never touch a device array, so this
        stage makes ZERO device fetches. The quota-ledger snapshot rides along so
        the pick's admission verdict is rendered against ONE
        consistent ledger; the authoritative charge still lands
        dispatch-side, against the live ledger, when the admission
        actually allocates (slo/quota.py ledger_view)."""
        choice = self._sched.peek_admission(self._admitting)
        quota = getattr(self.srv, "kv_quota", None)
        head = self._sched.peek()
        self._next_pick_plan = {
            "choice": choice,
            "admitting": tuple(sorted(
                (s, r.seq) for s, r in self._admitting.items())),
            "head": head,
            "ledger": (quota.ledger_view()
                       if quota is not None else None),
        }
        if self._host_tier is not None and head is not None:
            # Host-tier prefetch: stage the head request's tier-resident
            # chain on the card NOW, on a side stream, so its admission's
            # promotion consumes an upload that rode this tick's dispatch
            # in flight. Host-to-device only: still zero fetches in this
            # stage. Best effort: a failure leaves the admission to pay
            # its own upload (or recompute).
            try:
                self.srv.prefetch_prefix(
                    np.asarray(head.prompt, np.int32),
                    adapter=getattr(head, "adapter", -1))
            except Exception:               # noqa: BLE001 — counted
                self._prefetch_errors += 1

    def _complete_admission(self, slot: int, tok: int) -> None:
        """An admission's final chunk ran (fused or serial): its first
        sampled token starts the stream and the slot joins the decode
        batch."""
        req = self._admitting.pop(slot)
        self._emit(req, tok)
        self._active[slot] = req
        self._maybe_finish(slot, tok)

    def _advance_one_admission(self, slot: int,
                               gen: Optional[int] = None) -> None:
        """Serial admission tick (one chunk, its own forward) — the
        no-active-decodes fast path, and the decode-starved half of
        the token-budget alternation. The tick budget caps this chunk
        too (an admission-only tick must not smuggle a full unbounded
        chunk past the latency bound the budget promises)."""
        self._fault_forward()       # chaos: this tick's model forward
        self._check_superseded(gen)  # wedge hang fired above: abort
        f0 = self.srv.device_fetches
        tok = self.srv.admit_step(
            slot, max_chunk_tokens=self._tick_token_budget or None)
        self._stats["device_fetches"] += self.srv.device_fetches - f0
        self._stats["model_forwards"] += 1
        self._stats["work_ticks"] += 1
        if tok is None:
            return
        if self._tok_bad(tok):
            self._quarantine_slot(slot, self._admitting,
                                  "NaN token (poisoned prefill)")
            return
        self._complete_admission(slot, tok)

    def _tick(self, gen: Optional[int] = None) -> None:
        if self._overlap_tick:
            self._tick_overlap(gen)
        else:
            self._tick_serial(gen)

    def _tick_serial(self, gen: Optional[int] = None) -> None:
        """The pre-pipeline tick: schedule, dispatch, and fetch in one
        sequential pass. ``--overlap-tick off`` routes here — the
        fallback the overlapped mode must stay bit-exact against."""
        if self._mesh_preamble():
            return
        admitted = True
        while admitted and self._mesh_fault is None:
            admitted = self._try_admit()    # drain as slots allow
        if self._mesh_fault is not None:
            # An admission dispatch flagged a mesh fault mid-drain:
            # reshard NOW, before another pop lands on the broken
            # placement.
            self._reshard(self._mesh_fault)
            return
        work = self._pick_admission()
        if not self._active:
            # No decode batch to fuse into: serial admission (one
            # chunk per tick) is the fast path.
            if work is not None:
                self._advance_one_admission(work, gen)
            elif not self._admitting:
                if self._maybe_grow_back():
                    return
                time.sleep(self._idle_sleep_s)
            return
        # Reap cancelled (timed-out) requests before paying for a step.
        for slot in [s for s, r in self._active.items() if r.cancelled]:
            self._maybe_finish(slot, -1)
        if not self._active:
            return
        # Fused tick: the admission's next chunk rides the decode
        # batch's forward (exactly one model forward — and still one
        # device->host transfer — per tick). `room` caps the chunk so
        # decode-rows + chunk tokens stay within the tick budget.
        room = None
        if work is not None and self._tick_token_budget:
            room = self._tick_token_budget - len(self._active)
            if room < self._chunk_gran:
                # No chunk fits beside this decode batch: decode-only
                # and admission-only ticks take turns so neither side
                # starves while per-tick work stays bounded — unless
                # the tier ladder overrides (an at-risk higher-tier
                # admission claims the tick; a lower-tier admission
                # never steals one from higher-tier decode rows).
                choice = self._sched.alternation(self._admitting[work],
                                                 self._active)
                if choice is None:
                    choice = "admit" if self._admit_turn else "decode"
                    self._admit_turn = not self._admit_turn
                if choice == "admit":
                    self._advance_one_admission(work, gen)
                    return
                work, room = None, None
        self._fault_forward()       # chaos: this tick's model forward
        self._check_superseded(gen)  # wedge hang fired above: abort
        f0 = self.srv.device_fetches
        try:
            out = (self.srv.step(prefill_work=work,
                                 max_chunk_tokens=room)
                   if work is not None else self.srv.step())
        except self._pool_exhausted as e:
            # Pool exhausted by concurrent decode growth (admission does
            # not reserve max_tokens worth of blocks, by design — that
            # would waste most of the pool). Shed ONE victim and retry
            # next tick rather than 503ing every in-flight request.
            # Typed catch: any OTHER RuntimeError is a device/runtime
            # failure and belongs to the quarantine path in _loop.
            if self._preempt_one():
                self._stats["engine_errors"] += 1
                self._stats["last_error"] = f"preempt: {e}"
                return
            raise
        except self._slot_cap_exceeded as e:
            # ONE slot's block table is full: a per-slot ceiling, not
            # a device fault. Retire exactly that request at its
            # tokens-so-far (the paged analog of dense max_len
            # retirement) — preempting or quarantining the batch over
            # one sequence's ceiling would punish the innocents.
            req = self._active.pop(e.slot, None)
            self._safe_evict(e.slot)
            self._stats["last_error"] = str(e)
            if req is not None:
                self._finish_completed(req)
                return
            raise                       # not ours: a real engine bug
        self._stats["steps"] += 1
        self._stats["device_fetches"] += self.srv.device_fetches - f0
        self._stats["model_forwards"] += 1
        self._stats["work_ticks"] += 1
        if work is not None:
            self._stats["fused_ticks"] += 1
        self._apply_step_output(out, work)

    def _apply_step_output(self, out, work: Optional[int],
                           retired=None) -> None:
        """Post-fetch half of a tick: NaN quarantine scan, token
        emission, fused-admission completion, capacity reap. Shared
        verbatim by the serial tick and the overlapped finalize so the
        two modes cannot drift. ``retired``: {slot: request} for rows
        the dispatch retired at capacity whose slot was already handed
        back (overlap pre-reap) — their final tokens are emitted to
        the request directly, exactly where the serial emit loop would
        have."""
        # Token-fetch validation (the NaN failure domain is ONE slot):
        # a NaN/garbage token means that slot's forward produced
        # poisoned logits — quarantine exactly that slot and drop its
        # whole tick output; everyone else's tokens are good. Pure
        # host arithmetic: no extra device transfer on this path.
        poisoned = self._fault_token_fetch(out)
        if poisoned is not None:
            out = poisoned
        bad = [s for s, toks in out.items()
               if any(self._tok_bad(t) for t in
                      (toks if isinstance(toks, list) else [toks]))]
        for s in bad:
            out.pop(s)
            self._stats["last_error"] = f"NaN token from slot {s}"
            if s in self._active:
                self._quarantine_slot(s, self._active,
                                      "NaN token (poisoned logits)")
            elif s in self._admitting:
                self._quarantine_slot(s, self._admitting,
                                      "NaN token (poisoned logits)")
            elif retired and s in retired:
                # Quarantine minus the evict (the pre-reap already
                # returned the slot): suspect tokens never reach the
                # stream; the request replays or 503s like any other
                # quarantined row.
                done = retired.pop(s)
                self._stats["quarantines"] += 1
                self._tier_stats.bump(done.tier, "quarantined")
                self._unpark_tenant(done.tenant)
                self._replay_or_503(done, "NaN token (poisoned logits)")
        for slot, toks in out.items():
            req = self._active.get(slot)
            if req is None and retired:
                done = retired.pop(slot, None)
                if done is not None:
                    # Capacity-retired mid-flight: emit its final
                    # tokens, then complete it at tokens-so-far —
                    # the serial reap's outcome, one stage later.
                    self._stats["slot_rounds"] += 1
                    for tok in (toks if isinstance(toks, list)
                                else [toks]):
                        self._emit(done, tok)
                        self._stats["tokens_out"] += 1
                    self._finish_completed(done)
                    continue
            if req is None:
                continue
            # One (slot, step) emission — the per-slot denominator the
            # speculative acceptance stat divides by (tokens_out/steps
            # would conflate batch concurrency with acceptance).
            self._stats["slot_rounds"] += 1
            # Speculative servers emit a LIST per slot (up to gamma+1
            # accepted tokens); _maybe_finish per token keeps ONE
            # source of truth for the finish predicate — tokens
            # accepted past a mid-block eos are discarded (the slot is
            # evicted; its advanced device lengths are moot).
            for tok in (toks if isinstance(toks, list) else [toks]):
                self._emit(req, tok)
                self._stats["tokens_out"] += 1
                self._maybe_finish(slot, tok)
                if slot not in self._active:
                    break
        # A fused chunk that completed its admission reports the first
        # sampled token under the admitting slot's key.
        if work is not None and work in self._admitting and work in out:
            self._complete_admission(work, out[work])
        # A retired row whose tokens were all dropped (NaN scan) or
        # absent still completes at tokens-so-far, like the serial
        # reap would have.
        if retired:
            for req in retired.values():
                self._finish_completed(req)
        # A slot step() deactivated at capacity without our evict:
        for slot in [s for s in self._active
                     if not self.srv.active[s]]:
            req = self._active.pop(slot)
            self._safe_evict(slot)          # reclaim blocks (counted
            self._finish_completed(req)     # on failure, never raised
                                            # past the finished request

    # -- overlapped tick pipeline ------------------------------------
    def _tick_overlap(self, gen: Optional[int] = None) -> None:
        """Two-stage pipelined tick: finalize (fetch) the PREVIOUS
        tick's in-flight dispatch, then schedule and dispatch this
        one — so this tick's host scheduling and the previous tick's
        journal fsync ride the device window of the dispatch in
        flight, and the one device fetch lands one tick late
        (fetches_per_tick stays <= 1.0). On the card the dispatch
        returns with its work enqueued and no host wait, so the host
        stages below overlap the device work. Stage order:

          1. admit drain — the same pre-dispatch point as the serial
                           tick, so admission timing matches serial
                           exactly; a pre-reap first returns any
                           capacity-retired in-flight slots before the
                           drain can hand them to new requests
          2. finalize    — the ONE deferred device fetch, applied
                           through the exact serial post-step block
                           (NaN scan, emit, fused completion, reap)
          3. schedule    — pure pick: the overlap-window plan is
                           committed when still valid, else recomputed
          4. dispatch    — step_async, stash the generation-stamped
                           _PendingTick, then precompute the next
                           pick inside the freshly opened window
        """
        if self._mesh_preamble():
            return
        self._prereap_retired()
        admitted = True
        while admitted and self._mesh_fault is None:
            admitted = self._try_admit()    # drain as slots allow
        if self._mesh_fault is not None:
            # An admission dispatch flagged a mesh fault mid-drain: the
            # in-flight dispatch is as suspect as the admission.
            self._flush_pipeline()
            self._reshard(self._mesh_fault)
            return
        q0 = self._stats["quarantines"]
        finalized = self._finalize_pending()
        if finalized and self._stats["quarantines"] == q0:
            # Completions in the finalize freed server slots; refill
            # them NOW, like the serial tick's drain (which runs after
            # the previous tick is fully applied) — otherwise every
            # completion opens a one-tick admission bubble the serial
            # engine does not have. Skipped when the finalize
            # quarantined: a replayed request re-admits at the NEXT
            # tick's drain, keeping the recovery tick itself at the
            # one transfer the sync-free invariant allows.
            admitted = True
            while admitted and self._mesh_fault is None:
                admitted = self._try_admit()
            if self._mesh_fault is not None:
                self._flush_pipeline()
                self._reshard(self._mesh_fault)
                return
        self._schedule_and_dispatch(gen, finalized)

    def _prereap_retired(self) -> None:
        """Dispatch-side capacity retirement (dense max_len, paged
        slot ceiling) frees the server's slot while its final token is
        still in flight. Move those rows out of ``_active`` — and
        reclaim their server-side state — BEFORE the admission drain
        can hand the slot to a new request; their tokens are emitted
        at finalize from the pending tick's own identity map, so the
        stream still ends exactly where the serial engine's would."""
        pend = self._pending_tick
        if pend is None:
            return
        for slot, req in list(pend.slot_reqs.items()):
            if (self._active.get(slot) is req
                    and not self.srv.active[slot]):
                del self._active[slot]
                self._safe_evict(slot)
                pend.retired[slot] = req

    def _finalize_pending(self) -> bool:
        """Stage 3: the one deferred device fetch. Slots whose request
        changed while the tick was in flight (preempted, quarantined,
        completed-and-recycled) are invalidated — the generation-
        stamped identity map decides, so a recycled slot can never
        receive the old dispatch's token. Returns True when a pending
        tick was actually fetched (the caller then defers any serial
        admission forward to keep one fetch per tick)."""
        pend, self._pending_tick = self._pending_tick, None
        if pend is None:
            return False
        if pend.engine_gen != self._engine_gen:
            # Stamped under a previous engine generation: its device
            # work answers for state that was quarantined and replayed
            # — drop it unfetched.
            self._pipeline_flushes += 1
            return False
        stale = frozenset(
            s for s, req in pend.slot_reqs.items()
            if (self._active.get(s) is not req
                and self._admitting.get(s) is not req
                and s not in pend.retired))
        f1 = self.srv.device_fetches
        try:
            out = pend.step.finalize(stale)
        except BaseException:
            # The deferred fetch surfaced the dispatch's device fault.
            # Pre-reaped retired rows live in no store the quarantine
            # sweep can see — replay them here, then let the fault
            # take the normal quarantine path for everyone else.
            for req in pend.retired.values():
                self._stats["quarantines"] += 1
                self._tier_stats.bump(req.tier, "quarantined")
                self._unpark_tenant(req.tenant)
                self._replay_or_503(req,
                                    "device fault at pipeline finalize")
            raise
        self._stats["steps"] += 1
        # Fetch accounting joins the two halves of the split tick:
        # the dispatch-side delta (zero on the async path; the eager
        # monkeypatch fallback pays there) plus the finalize fetch —
        # admission transfers in between stay excluded, exactly as
        # the serial tick excludes them.
        self._stats["device_fetches"] += (
            pend.dispatch_fetches + (self.srv.device_fetches - f1))
        self._apply_step_output(out, pend.work, retired=pend.retired)
        self._gap_anchor = time.monotonic()
        return True

    def _schedule_and_dispatch(self, gen: Optional[int],
                               finalized: bool) -> None:
        """Stages 4+5. State is serial-equivalent here — the previous
        tick is fully applied — so every decision matches what the
        serial engine would choose. ``finalized`` gates the serial
        admission forward: a tick that already paid the finalize fetch
        defers it one tick, keeping the one-fetch-per-tick invariant
        airtight instead of merely average."""
        work = self._pick_admission_planned()
        if not self._active:
            if work is not None:
                if finalized:
                    return
                self._advance_one_admission(work, gen)
            elif not self._admitting:
                if self._maybe_grow_back():
                    return
                time.sleep(self._idle_sleep_s)
            return
        # Reap cancelled (timed-out) requests before paying for a step.
        for slot in [s for s, r in self._active.items() if r.cancelled]:
            self._maybe_finish(slot, -1)
        if not self._active:
            return
        room = None
        if work is not None and self._tick_token_budget:
            room = self._tick_token_budget - len(self._active)
            if room < self._chunk_gran:
                choice = self._sched.alternation(self._admitting[work],
                                                 self._active)
                if choice is None:
                    if finalized and self._admit_turn:
                        # Admission's turn, but this tick already paid
                        # the finalize fetch: hold the turn untoggled
                        # and run the chunk next tick (which dispatches
                        # nothing else).
                        return
                    choice = "admit" if self._admit_turn else "decode"
                    self._admit_turn = not self._admit_turn
                if choice == "admit":
                    if finalized:
                        return          # at-risk claim stands next tick
                    self._advance_one_admission(work, gen)
                    return
                work, room = None, None
        self._fault_forward()       # chaos: this tick's model forward
        self._check_superseded(gen)  # wedge hang fired above: abort
        slot_reqs = dict(self._active)
        if work is not None:
            slot_reqs[work] = self._admitting[work]
        f0 = self.srv.device_fetches
        # Instance-level step overrides (chaos/unit tests monkeypatch
        # eng.srv.step) see exactly the serial call — eagerly, with
        # exceptions raising at dispatch — and their output rides the
        # pipeline pre-fetched.
        eager = ("step" in vars(self.srv)
                 or not hasattr(self.srv, "step_async"))
        try:
            if eager:
                from tpushare_torch.models.serving import PendingStep
                out = (self.srv.step(prefill_work=work,
                                     max_chunk_tokens=room)
                       if work is not None else self.srv.step())
                pstep = PendingStep.done(out)
            else:
                pstep = (self.srv.step_async(prefill_work=work,
                                             max_chunk_tokens=room)
                         if work is not None
                         else self.srv.step_async())
        except self._pool_exhausted as e:
            # Same shed-one-victim contract as the serial tick (see
            # _tick_serial): these raise host-side at dispatch, so the
            # pipeline holds nothing suspect.
            if self._preempt_one():
                self._stats["engine_errors"] += 1
                self._stats["last_error"] = f"preempt: {e}"
                return
            raise
        except self._slot_cap_exceeded as e:
            req = self._active.pop(e.slot, None)
            self._safe_evict(e.slot)
            self._stats["last_error"] = str(e)
            if req is not None:
                self._finish_completed(req)
                return
            raise                       # not ours: a real engine bug
        self._dispatch_seq += 1
        self._pending_tick = _PendingTick(
            pstep, engine_gen=self._engine_gen,
            tick_id=self._dispatch_seq, slot_reqs=slot_reqs,
            work=work, dispatch_fetches=self.srv.device_fetches - f0)
        self._stats["model_forwards"] += 1
        self._stats["work_ticks"] += 1
        if work is not None:
            self._stats["fused_ticks"] += 1
        self._record_host_gap()
        self._plan_next_pick()

    def _flush_pipeline(self) -> None:
        """Abandon the in-flight dispatch WITHOUT its fetch: its
        tokens are never observed (quarantine replay regenerates them
        token-exactly), so a reshard/quarantine path never blocks on —
        or trusts — a suspect device computation. Counted on the
        /stats ``pipeline_flushes`` surface."""
        if self._pending_tick is None:
            return
        self._pending_tick = None
        self._next_pick_plan = None
        self._pipeline_flushes += 1

    def _record_host_gap(self) -> None:
        """One host-gap sample: finalize done -> this dispatch
        launched, the host-side scheduling span the overlap hides.
        Plain monotonic deltas into a bounded ring (no PhaseTimer —
        its barriers are the syncs the hot loop must never make)."""
        anchor, self._gap_anchor = self._gap_anchor, None
        if anchor is None:
            return
        from tpushare_torch.utils.profiling import HOST_GAP_CAP
        self._host_gap_ms.append((time.monotonic() - anchor) * 1e3)
        if len(self._host_gap_ms) > HOST_GAP_CAP:
            del self._host_gap_ms[
                :len(self._host_gap_ms) - HOST_GAP_CAP]


def chip_to_device(chip: int) -> int:
    """Map a plugin chip index (the vocabulary of the injected grant
    and the health hooks) to the engine's device POSITION: its index in
    the sorted grant (utils/tenant.read_tenant_env). Without a grant
    env (tests, bare runs) the identity mapping applies; a poisoned
    err-as-env grant fails loudly."""
    from tpushare_torch.utils.tenant import AllocationError, read_tenant_env
    try:
        granted = sorted(read_tenant_env().chips)
    except AllocationError as e:
        raise ValueError(f"cannot map chip {chip}: poisoned "
                         f"err-as-env grant ({e})")
    if not granted:
        return chip
    try:
        return granted.index(int(chip))
    except ValueError:
        raise ValueError(f"chip {chip} is not in this pod's grant "
                         f"{granted}")


def make_handler(engine: ServeEngine, timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):           # quiet by default
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _stream(self, req: _Request, from_n: int = 0,
                    resume: bool = False,
                    can_cancel: Optional[bool] = None) -> None:
            """SSE token stream, event-driven: the engine's push()/
            finish() notify ``req.cond``, so each token flushes the
            moment it exists — no poll quantum under any token and no
            wakeups while the engine computes. Events are written
            OUTSIDE the condition lock (the engine must never block on
            a slow client's socket). A broken pipe (client gone)
            cancels the generation so the slot frees instead of
            decoding to max_tokens for nobody.

            Every token event carries a monotonic ``id:`` line (the
            count of tokens delivered INCLUDING this one) — the
            resume cursor GET /v1/completions/{id} and Last-Event-ID
            speak. ``from_n`` skips the first N tokens, so a resumed
            stream's token events are byte-identical to the
            uninterrupted stream's from that cursor. ``resume``
            streams — and ATTACHED (Idempotency-Key deduped) POST
            streams, via ``can_cancel=False`` — are a read-only view:
            they never cancel the generation (only the original owner
            holds that right; a retry's dropped connection must not
            kill the stream the owner is still consuming), and a
            resume's done event omits cached_prefix (an
            admission-time detail a recovered request cannot
            reproduce)."""
            if can_cancel is None:
                can_cancel = not resume
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("X-Request-Id", req.request_id)
            self.end_headers()          # HTTP/1.0: close-delimited body

            def event(obj, eid: Optional[int] = None) -> None:
                frame = b""
                if eid is not None:
                    frame += b"id: %d\n" % eid
                frame += b"data: " + json.dumps(obj).encode() + b"\n\n"
                self.wfile.write(frame)
                self.wfile.flush()

            sent = max(0, int(from_n))
            deadline = time.time() + timeout_s
            try:
                while True:
                    with req.cond:
                        req.cond.wait_for(
                            lambda: len(req.tokens) > sent
                            or req.done.is_set(),
                            timeout=max(0.0, deadline - time.time()))
                    # Sample done BEFORE draining: every push precedes
                    # finish(), so done-then-drain sees all tokens; a
                    # push landing after the drain wakes the next
                    # iteration. (Drain-then-check could break on a
                    # push+finish pair landing between the two.)
                    done = req.done.is_set()
                    toks = req.tokens        # drain outside the lock
                    while sent < len(toks):
                        event({"token": toks[sent]}, eid=sent + 1)
                        sent += 1
                    if done:
                        break
                    if time.time() > deadline:
                        if can_cancel:
                            req.cancelled = True
                        event({"error": "generation timed out"})
                        return
                if req.error:
                    event({"error": req.error})
                elif resume:
                    event({"done": True}, eid=sent)
                else:
                    event({"done": True,
                           "cached_prefix": req.cached_prefix},
                          eid=sent)
            except (BrokenPipeError, ConnectionResetError):
                if can_cancel:
                    req.cancelled = True    # engine reaps the slot

        def do_GET(self):
            if self.path == "/healthz":
                # LIVENESS only: draining/restarting replicas answer
                # ok=True (the supervisor will bring the engine back;
                # killing the pod would turn a recoverable restart
                # into a lost replica). Routability is /readyz.
                ok = engine.healthy()
                self._json(200 if ok else 503,
                           {"ok": ok, "state": engine.state()})
            elif self.path == "/readyz":
                # READINESS: 503 while draining/restarting so the
                # router and the k8s readiness probe stop sending new
                # work — without the liveness probe killing the pod.
                ok = engine.ready()
                self._json(200 if ok else 503,
                           {"ready": ok, "state": engine.state()})
            elif self.path == "/prefixes":
                self._json(200, engine.prefix_keys())
            elif self.path == "/stats":
                self._json(200, engine.stats())
            elif self.path.startswith("/v1/completions/"):
                self._resume_stream()
            elif self.path.startswith("/kv/blocks"):
                # Migration source: raw block payloads by chain digest
                # to a pulling sibling. Keys it no longer holds are
                # omitted — partial answers ARE the gossip-staleness
                # contract.
                import urllib.parse as _up
                qs = _up.parse_qs(_up.urlparse(self.path).query)
                keys = [k for k in
                        (qs.get("keys", [""])[0] or "").split(",") if k]
                self._json(200, engine.kv_blocks(keys))
            else:
                self._json(404, {"error": "not found"})

        def _resume_stream(self) -> None:
            """GET /v1/completions/{id}?from=N: re-open a
            request's event stream from cursor N — after a client
            drop, a router failover, or a serve-process death (the
            recovered request keeps its id). ?from= wins; the
            standard Last-Event-ID header is honored otherwise; no
            cursor replays from 0."""
            import urllib.parse as _up
            parsed = _up.urlparse(self.path)
            rid = parsed.path[len("/v1/completions/"):]
            if not rid or "/" in rid:
                self._json(404, {"error": "not found"})
                return
            req = engine.request_by_id(rid)
            if req is None:
                self._json(404, {
                    "error": f"unknown request id {rid!r} (completed "
                             f"requests age out of the dedupe "
                             f"window)"})
                return
            try:
                qs = _up.parse_qs(parsed.query)
                if "from" in qs:
                    from_n = int(qs["from"][0])
                else:
                    from_n = int(self.headers.get("Last-Event-ID", 0))
                if from_n < 0:
                    raise ValueError
            except (ValueError, TypeError):
                self._json(400, {"error": "from/Last-Event-ID must "
                                          "be a non-negative int"})
                return
            engine.note_resumed()
            self._stream(req, from_n=from_n, resume=True)

        def do_POST(self):
            if self.path == "/mesh/chip":
                # Per-chip health churn: {"device": i} names a device
                # position directly; {"chip": c} names a granted chip
                # index (the plugin health hook's vocabulary) and maps
                # through the grant. The port's unsharded engine drains
                # on loss and undrains on recovery.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    healthy = body.get("healthy", False)
                    if not isinstance(healthy, bool):
                        raise ValueError("healthy must be a bool")
                    if "device" in body:
                        dev = body["device"]
                    elif "chip" in body:
                        chip = body["chip"]
                        if isinstance(chip, bool) or not isinstance(
                                chip, int):
                            raise ValueError("chip must be an int")
                        dev = chip_to_device(chip)
                    else:
                        raise ValueError(
                            "need 'device' (mesh position) or 'chip' "
                            "(granted chip index)")
                    if isinstance(dev, bool) or not isinstance(
                            dev, int):
                        raise ValueError("device must be an int")
                    out = engine.chip_event(dev, healthy)
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, out)
                return
            if self.path == "/mesh/host":
                # Whole-host health churn: {"rank": r, "healthy":
                # bool} moves one host's whole rank range at once. Only
                # process-aware engines (num_processes on a mesh)
                # accept it; others answer 400.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    healthy = body.get("healthy", False)
                    if not isinstance(healthy, bool):
                        raise ValueError("healthy must be a bool")
                    rank = body.get("rank")
                    if isinstance(rank, bool) or not isinstance(
                            rank, int):
                        raise ValueError("rank must be an int")
                    out = engine.host_event(rank, healthy)
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, out)
                return
            if self.path == "/undrain":
                ok = engine.end_drain()
                self._json(200 if ok else 409,
                           {"draining": engine._draining.is_set(),
                            "state": engine.state()})
                return
            if self.path == "/drain":
                # Device-health churn, tenant side: the co-located
                # plugin POSTs this when a chip the pod sits on goes
                # unhealthy (plugin/health.serve_drain_hook). New work
                # is refused at submit(); accepted work finishes.
                engine.begin_drain()
                self._json(200, {"draining": True,
                                 "state": engine.state()})
                return
            if self.path == "/kv/migrate":
                # Migration sink: the router instructs this replica to
                # pull a published chain from a sibling into its host
                # tier ahead of the proxied admission. Failures answer
                # 200 with migrated=0 — migration is an optimization;
                # local recompute is the default path either way.
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    if not isinstance(body, dict):
                        raise ValueError("body must be a JSON object")
                    src = body.get("source")
                    keys = body.get("keys")
                    if not isinstance(src, str) or not src:
                        raise ValueError(
                            "source must be a replica base URL")
                    if (not isinstance(keys, list) or not keys
                            or not all(isinstance(k, str)
                                       for k in keys)):
                        raise ValueError(
                            "keys must be a non-empty list of hex "
                            "chain digests")
                    tn = body.get("tenant")
                    if tn is not None and (not isinstance(tn, str)
                                           or not tn):
                        raise ValueError(
                            "tenant must be a non-empty string")
                except (KeyError, ValueError, TypeError,
                        json.JSONDecodeError) as e:
                    self._json(400, {"error": str(e)})
                    return
                self._json(200, engine.kv_migrate(src, keys,
                                                  tenant=tn))
                return
            if self.path != "/v1/completions":
                self._json(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(body, dict):
                    raise ValueError("body must be a JSON object")
                prompt = body["prompt"]
                vocab = engine.srv.cfg.vocab_size
                if (not isinstance(prompt, list) or not prompt
                        or not all(isinstance(t, int)
                                   and 0 <= t < vocab for t in prompt)):
                    raise ValueError(
                        "prompt must be a non-empty list of token ids "
                        f"in [0, {vocab})")
                mt = body.get("max_tokens", 16)
                if (not isinstance(mt, int) or mt < 1
                        or mt > engine.max_tokens_cap):
                    raise ValueError(
                        f"max_tokens must be an int in "
                        f"[1, {engine.max_tokens_cap}]")
                eos = body.get("eos")
                if eos is not None and not isinstance(eos, int):
                    raise ValueError("eos must be an int token id")
                adapter = body.get("adapter", -1)
                if isinstance(adapter, bool) or not isinstance(
                        adapter, int):
                    # bool subclasses int: {"adapter": true} would
                    # silently select adapter 1 — another tenant.
                    raise ValueError("adapter must be an int bank "
                                     "index (-1 = base model)")
                stream = bool(body.get("stream", False))
                # SLO identity: "tier" orders the request against the
                # rest of the traffic (unknown names 400 — a typo'd
                # tier silently landing in the default would be an
                # unasked-for SLO downgrade); "tenant" is the KV-quota
                # accounting principal.
                tier = parse_tier(body.get("tier"),
                                  getattr(engine, "default_tier",
                                          DEFAULT_TIER),
                                  specs=getattr(engine, "tier_specs",
                                                None))
                tenant = body.get("tenant", "default")
                if not isinstance(tenant, str) or not tenant:
                    raise ValueError(
                        "tenant must be a non-empty string")
                req = _Request(prompt, mt, eos, adapter,
                               tier=tier, tenant=tenant)
                req.idem_key = (self.headers.get("Idempotency-Key")
                                or None)
            except (KeyError, ValueError, TypeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            # Exactly-once admission: an Idempotency-Key that
            # already names a request RE-ATTACHES to it — live or
            # completed — instead of double-executing; the same key
            # with a different prompt is a 409 (a client bug, not a
            # retry). getattr: test fakes implement only submit().
            reg = getattr(engine, "register_or_attach", None)
            attached = conflict = False
            if reg is not None:
                req, attached, conflict = reg(req)
            if conflict:
                self._json(409, {
                    "error": "Idempotency-Key reuse with a different "
                             "prompt (a retry must resend the same "
                             "request)"})
                return
            if not attached and not engine.submit(req):
                if reg is not None:     # never accepted: the key must
                    engine.deregister(req)  # not pin a request that
                self._json(429, {"error": "queue full, retry later"})
                return                  # will never run
            if stream:
                # An attached stream is a read-only view: its dropped
                # connection/timeout must never cancel a generation
                # the original owner is still consuming.
                self._stream(req, can_cancel=not attached)
                return
            if not req.done.wait(timeout=timeout_s):
                if not attached:
                    # Tell the engine to free the slot — an abandoned
                    # request must not decode toward max_tokens
                    # forever. An ATTACHED waiter never cancels: the
                    # original owner (or a later resume) may still be
                    # consuming the stream.
                    req.cancelled = True
                self._json(504, {"error": "generation timed out"})
                return
            if req.error:
                self._json(req.status, {"error": req.error,
                                        "id": req.request_id})
                return
            self._json(200, {"id": req.request_id,
                             "tokens": req.tokens,
                             "cached_prefix": req.cached_prefix})
    return Handler


def serve(engine: ServeEngine, host: str = "127.0.0.1", port: int = 8478,
          timeout_s: float = 300.0,
          daemon_threads: bool = True) -> ThreadingHTTPServer:
    """Start the engine + HTTP server; returns the (running) server.
    Caller owns shutdown: server.shutdown(); engine.stop().

    ``daemon_threads=False`` makes handler threads non-daemon so
    ``server_close()`` joins them — the drain path needs this, or the
    process could exit between the engine finishing a request and the
    handler writing its response bytes (client sees a reset for a
    request the server 'completed')."""
    engine.start()
    httpd = ThreadingHTTPServer((host, port),
                                make_handler(engine, timeout_s))
    httpd.daemon_threads = daemon_threads
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    return httpd


def build_parser() -> argparse.ArgumentParser:
    """The tpushare-torch-serve argv contract: the reference daemon's
    flags, with ``--device`` in place of ``--platform`` — split from
    main() so callers (tests, chip_smoke.py) parse a pod's argv exactly
    as the daemon would."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="tiny",
                    choices=["tiny", "gemma_2b", "llama3_8b"])
    ap.add_argument("--dtype", default="",
                    choices=["", "float32", "bfloat16"],
                    help="the dense model's weight and activation dtype "
                         "(default: the preset's)")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="the dense model's depth, cut from the preset's "
                         "(default: the preset's)")
    ap.add_argument("--model-family", default="dense",
                    choices=["dense", "moe"],
                    help="moe: serve the MoE LM via MoESlotServer "
                         "(dense KV rows at --max-len; --preset tiny "
                         "maps to moe.tiny; paged-only flags are "
                         "rejected). Converted Mixtral checkpoints "
                         "serve through the same engine via the API "
                         "(convert.moe_config_from_hf)")
    ap.add_argument("--max-len", type=int, default=None,
                    help="per-slot context length for --model-family "
                         "moe with --kv rows (default 2048). Rejected "
                         "elsewhere — paged context is --n-blocks x "
                         "--block-size")
    ap.add_argument("--kv", default=None, choices=["rows", "paged"],
                    help="KV layout for --model-family moe: 'rows' "
                         "(default) or 'paged' (the dense family's "
                         "block pool via moe.paged_forward). The dense "
                         "family is always paged")
    ap.add_argument("--int8-experts", action="store_true",
                    help="moe only: serve an int8 quantize_params tree")
    ap.add_argument("--int8-expert-hook", choices=["fused", "dequant"],
                    default=None,
                    help="moe + --int8-experts only: 'fused' (default) "
                         "keeps expert weights int8 through the fused "
                         "expert kernel (ops/q8_expert); 'dequant' "
                         "widens each layer's leaves (quant.dequant_hook)")
    ap.add_argument("--mesh", default="",
                    help="serving mesh spec over the granted cards, "
                         "e.g. 'tp=2' or 'ep=2,tp=2' (-1 absorbs the "
                         "rest): one process per rank, each started "
                         "with --rank and --dist-init; ranks above 0 "
                         "follow rank 0's server")
    ap.add_argument("--rank", type=int, default=0,
                    help="this process's rank on --mesh (0 serves "
                         "HTTP; the others replay its server calls)")
    ap.add_argument("--dist-init", default="",
                    help="torch.distributed init method every rank of "
                         "--mesh meets at, e.g. tcp://localhost:29511")
    ap.add_argument("--process-view", type=int, default=0,
                    metavar="N",
                    help="group the mesh's ranks into N hosts of "
                         "contiguous ranks: rank 0 runs the gang "
                         "liaison one port above --dist-init, the "
                         "first rank of every other host heartbeats to "
                         "it, and a host that falls silent (or POST "
                         "/mesh/host, or the host.loss chaos point) "
                         "reshards the mesh around its ranks. "
                         "Conflicts with a gang env grant")
    ap.add_argument("--device", default="",
                    help="torch device to serve on, e.g. 'cuda', "
                         "'cuda:1' or 'cpu' (default: the CUDA card; "
                         "exits when there is none)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8478)
    ap.add_argument("--n-slots", type=int, default=8)
    ap.add_argument("--n-blocks", type=int, default=None,
                    help="paged KV pool blocks (default 256)")
    ap.add_argument("--block-size", type=int, default=None,
                    help="paged KV block tokens (default 16)")
    ap.add_argument("--kv-quant", action="store_true")
    ap.add_argument("--no-prefix-cache", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="pending-request bound; overflow answers 429")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="split admissions longer than this many tokens "
                         "into block-aligned prefill chunks FUSED into "
                         "the decode batch's forward (0 = whole-prompt "
                         "admits). Values below "
                         f"{PREFILL_CHUNK_FLOOR} are clamped (see "
                         "--prefill-chunk-force)")
    ap.add_argument("--prefill-chunk-force", action="store_true",
                    help="keep a --prefill-chunk below the "
                         f"{PREFILL_CHUNK_FLOOR}-token floor instead of "
                         "clamping it")
    ap.add_argument("--tick-token-budget", type=int, default=0,
                    help="cap decode-rows + fused admission-chunk "
                         "tokens per engine tick (0 = unbounded). When "
                         "the budget leaves no chunk room beside the "
                         "decode batch, decode-only and admission-only "
                         "ticks alternate")
    ap.add_argument("--draft-preset", default="",
                    choices=["", "tiny", "gemma_2b", "int8-self"],
                    help="enable speculative decoding with this draft "
                         "model (same vocabulary; composes with "
                         "sampling through the exact stochastic "
                         "acceptance rule, models/spec.py). "
                         "'int8-self': the target's own int8 rounding "
                         "as the draft")
    ap.add_argument("--gamma", type=int, default=4,
                    help="draft tokens per speculative round (the "
                         "horizon multiplies this)")
    ap.add_argument("--spec-horizon", type=int, default=1,
                    help="multi-token draft horizon K: each round "
                         "drafts gamma*K tokens and verifies the block "
                         "in ONE target forward. Requires "
                         "--draft-preset; validated against "
                         "--tick-token-budget")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; >0 samples (composes with "
                         "--draft-preset via the exact stochastic "
                         "acceptance rule)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="truncate sampling to the k most likely "
                         "tokens (0 = off)")
    ap.add_argument("--top-p", type=float, default=1.0,
                    help="nucleus sampling mass cutoff (1.0 = off)")
    ap.add_argument("--chaos-spec", default=None,
                    help="deterministic fault injection (chaos), e.g. "
                         "'forward:raise@p=0.02;token_fetch:nan"
                         "@p=0.01;seed=7'. Default: the "
                         f"{ENV_CHAOS} env var; unset = no-op fault "
                         "points")
    ap.add_argument("--tick-deadline-ms", type=float, default=0,
                    help="per-engine-tick deadline; a tick running "
                         "longer counts a deadline_breaches /stats "
                         "breach (0 = off). Also bounds injected "
                         "'hang' faults")
    ap.add_argument("--journal-dir", default=None,
                    help="crash-only serving: write-ahead request "
                         "journal directory (ACCEPT -> per-tick TOKENS "
                         "-> DONE/CANCEL/FAILED, length-prefixed + "
                         "CRC32); a killed daemon restarted on the same "
                         "directory finishes every accepted stream "
                         "token-exact and keeps its Idempotency-Key "
                         "dedupe window. Unset = no journal")
    ap.add_argument("--journal-fsync", default="tick",
                    choices=["tick", "batch", "off"],
                    help="journal durability policy: 'tick' fsyncs "
                         "every work tick; 'batch' on segment "
                         "rotation/checkpoint; 'off' never")
    ap.add_argument("--tick-wedge-ms", type=float, default=0,
                    help="wedge watchdog: a tick stuck past this bound "
                         "is escalated to a hard engine restart through "
                         "the bounded --max-engine-restarts path "
                         "(0 = off)")
    ap.add_argument("--max-replays", type=int, default=3,
                    help="per-request quarantine-replay budget before "
                         "a clean 503")
    ap.add_argument("--max-engine-restarts", type=int, default=3,
                    help="engine-thread restarts (with backoff) the "
                         "loop supervisor attempts before /healthz "
                         "goes red")
    ap.add_argument("--max-reshards", type=int, default=3,
                    help="mesh-shrink (degrade-and-replay) budget for "
                         "a sharded engine: a card-health event or a "
                         "collective's transport error replays every "
                         "in-flight request token-exact on the largest "
                         "healthy sub-mesh, at most this many times "
                         "before the replica goes drained-sticky "
                         "(grow-backs are free; 0 keeps no weight "
                         "copy and never reshards)")
    ap.add_argument("--reshard-checkpoint", default=None,
                    help="reshard weight source (requires --mesh): a "
                         "safetensors file written once at boot, of "
                         "which each rank reads only its slices on a "
                         "reshard, instead of a host copy of the whole "
                         "tree per rank")
    from tpushare_torch.slo import TIER_ORDER
    ap.add_argument("--default-tier", default=DEFAULT_TIER,
                    choices=list(TIER_ORDER),
                    help="priority tier for requests that name none "
                         "(interactive outranks standard outranks "
                         "batch; the slo tier table)")
    ap.add_argument("--overlap-tick", choices=("on", "off"),
                    default="on",
                    help="overlapped tick pipeline: while tick N's "
                         "dispatch runs on the card, tick N+1's host "
                         "scheduling runs and the one device fetch "
                         "lands one tick late — streams stay bit-exact. "
                         "'off' restores the serial tick")
    ap.add_argument("--tenant-quota", default="",
                    help="per-tenant KV-pool block quotas: "
                         "'tenant=reserve:ceiling' pairs, comma-"
                         "separated (e.g. 'acme=16:64,bg=0:32'; empty "
                         "ceiling = unlimited burst). The plugin-"
                         "injected TPUSHARE_KV_BLOCK_RESERVE/_LIMIT env "
                         "grants a 'default'-tenant quota when no flag "
                         "names one")
    ap.add_argument("--host-kv-bytes", type=int, default=0,
                    help="host-RAM KV offload tier budget in bytes: "
                         "cold paged blocks DEMOTE to page-locked host "
                         "memory instead of being destroyed, and "
                         "promote back (prefetched in the overlap "
                         "window) on a prefix hit; also the landing "
                         "zone for cross-replica block migration "
                         "(POST /kv/migrate). 0 = no tier. Needs the "
                         "paged pool + prefix cache")
    return ap


def main() -> int:
    args = build_parser().parse_args()
    engine = build_engine(args)
    if args.mesh and args.rank > 0:
        # A follower rank: no HTTP surface, replay rank 0's calls.
        print(f"tpushare-torch-serve rank {args.rank} following "
              f"(mesh {args.mesh}, {engine.device})", flush=True)
        n = engine.follow(report=lambda r: print(json.dumps(
            {"mesh_generation_report": r}), flush=True))
        print(f"tpushare-torch-serve rank {args.rank}: rank 0 stopped "
              f"after {n} calls", flush=True)
        engine.stop()
        return 0
    httpd = serve(engine, args.host, args.port, daemon_threads=False)
    print(f"tpushare-torch-serve on {args.host}:{httpd.server_address[1]} "
          f"({args.model_family}/{args.preset}, {args.n_slots} slots, "
          f"{engine.device}"
          f"{', mesh ' + args.mesh if args.mesh else ''})", flush=True)

    # SIGTERM (the kubelet's preemption signal) drains: refuse new
    # work, finish accepted requests within the pod's grace period,
    # exit 0. SIGKILL after the grace period is the backstop.
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    try:
        while not stop.is_set():
            stop.wait(1.0)
        print("SIGTERM: draining", flush=True)
        engine.drain(timeout_s=25.0)
        httpd.shutdown()
        # Joins the (non-daemon) handler threads: every completed
        # request's response bytes reach the socket before exit.
        httpd.server_close()
        engine.stop()
        return 0
    except KeyboardInterrupt:
        return 0


def resolve_tenant_quotas(flag_text: str):
    """Per-tenant KV quotas: the plugin-injected env grant
    (TPUSHARE_KV_BLOCK_RESERVE/_LIMIT, the pod's "default" tenant)
    merges UNDER any explicit --tenant-quota pairs — per tenant, the
    flag wins, but a flag naming only OTHER tenants never discards the
    pod's own grant. None when neither names a quota. A poisoned env
    grant (limit < reserve) raises loudly."""
    from tpushare_torch.slo.quota import parse_quota_spec
    from tpushare_torch.utils.tenant import kv_quota_env
    quotas = parse_quota_spec(flag_text) if flag_text else {}
    for tenant, spec in (kv_quota_env() or {}).items():
        quotas.setdefault(tenant, spec)
    return quotas or None


def build_engine(args, **engine_kw) -> ServeEngine:
    """Build the engine exactly as ``tpushare-torch-serve`` would from
    parsed args, the CLI's validation guards included (the same
    SystemExit texts as the reference daemon for the same bad argv).
    Weights are the port's ``init_params`` from a generator seeded with
    ``--seed`` (real checkpoints load through the API: ServeEngine).
    Without ``--device`` the engine runs on the CUDA card and exits
    naming it when there is none. ``engine_kw`` are further
    ``ServeEngine`` options that have no flag (``multi_lora=bank``)."""
    if (args.prefill_chunk and args.prefill_chunk < PREFILL_CHUNK_FLOOR
            and not args.prefill_chunk_force):
        print(f"WARNING: --prefill-chunk {args.prefill_chunk} is below "
              f"the floor of {PREFILL_CHUNK_FLOOR} tokens; clamping to "
              f"{PREFILL_CHUNK_FLOOR}. Pass --prefill-chunk-force to "
              f"keep {args.prefill_chunk}.",
              file=sys.stderr, flush=True)
        args.prefill_chunk = PREFILL_CHUNK_FLOOR

    from tpushare_torch.utils.tenant import AllocationError
    try:
        quotas = resolve_tenant_quotas(getattr(args, "tenant_quota", ""))
    except ValueError as e:
        raise SystemExit(f"--tenant-quota: {e}")
    except AllocationError as e:
        raise SystemExit(f"KV-block env grant: {e}")
    default_tier = getattr(args, "default_tier", DEFAULT_TIER)

    # Speculation flags: validated LOUDLY before any device work.
    spec_horizon = getattr(args, "spec_horizon", 1)
    if spec_horizon < 1:
        raise SystemExit(f"--spec-horizon must be >= 1, got "
                         f"{spec_horizon}")
    if spec_horizon > 1 and not args.draft_preset:
        raise SystemExit("--spec-horizon is a speculation knob: it "
                         "multiplies --gamma's drafted block per "
                         "round, so it needs --draft-preset (no draft "
                         "model, nothing to draft)")
    if (args.draft_preset and args.tick_token_budget
            and args.tick_token_budget
            < args.gamma * spec_horizon + 1):
        raise SystemExit(
            f"--tick-token-budget {args.tick_token_budget} is below "
            f"the speculative round granule gamma*spec_horizon+1 = "
            f"{args.gamma * spec_horizon + 1}: a spec round cannot "
            f"be split (acceptance is decided on device), so every "
            f"round would emit past this budget and silently breach "
            f"the per-tick bound it promises. Raise the budget or "
            f"lower --gamma/--spec-horizon")

    try:
        device = resolve_device(getattr(args, "device", "") or None)
    except RuntimeError as e:
        raise SystemExit(f"--device: {e}")
    if getattr(args, "reshard_checkpoint", None) and not args.mesh:
        raise SystemExit("--reshard-checkpoint is the sharded "
                         "engine's reshard weight source; it needs "
                         "--mesh (an unsharded engine has no mesh "
                         "failure domain)")
    mesh = None
    num_processes, gang_host = 1, None
    if args.mesh:
        from tpushare_torch.parallel.multihost import initialize
        # A gang env grant (TPUSHARE_COORDINATOR / NUM_PROCESSES /
        # PROCESS_ID) names this process's rank and the rendezvous.
        contract = initialize()
        if contract is not None:
            args.rank = contract["process_id"]
            args.dist_init = args.dist_init or contract["init_method"]
        pview = int(getattr(args, "process_view", 0) or 0)
        if pview > 1 and contract is not None:
            raise SystemExit(
                "--process-view conflicts with a gang env grant "
                "(TPUSHARE_NUM_PROCESSES > 1)")
        num_processes = (contract["num_processes"] if contract
                         else max(1, pview))
        mesh = _cli_mesh(args, device, num_processes)
        device = mesh.device
        if num_processes > 1:
            gang_host = args.dist_init
    engine_kw = dict(engine_kw)
    if mesh is not None:
        engine_kw.setdefault("num_processes", num_processes)
        engine_kw.setdefault("max_reshards",
                             getattr(args, "max_reshards", 3))
        engine_kw.setdefault("reshard_checkpoint",
                             getattr(args, "reshard_checkpoint", None))
        if gang_host and mesh.process_id == 0:
            from tpushare_torch.parallel.gang import GangLeader
            host, port = _liaison_address(gang_host)
            engine_kw.setdefault("gang", GangLeader(
                num_processes, port=port, host=host))
    common = dict(
        n_slots=args.n_slots, n_blocks=args.n_blocks or 256,
        block_size=args.block_size or 16,
        prefix_cache=not args.no_prefix_cache,
        prefill_chunk=args.prefill_chunk or None,
        tick_token_budget=args.tick_token_budget,
        max_queue=args.max_queue, temperature=args.temperature,
        top_k=args.top_k or None,
        top_p=(args.top_p if args.top_p < 1.0 else None),
        seed=args.seed, gamma=args.gamma, spec_horizon=spec_horizon,
        chaos_spec=args.chaos_spec,
        tick_deadline_ms=(args.tick_deadline_ms or None),
        max_replays=args.max_replays,
        max_engine_restarts=args.max_engine_restarts,
        default_tier=default_tier, tenant_quotas=quotas,
        journal_dir=getattr(args, "journal_dir", None),
        journal_fsync=getattr(args, "journal_fsync", "tick"),
        tick_wedge_ms=(getattr(args, "tick_wedge_ms", 0) or None),
        overlap_tick=(getattr(args, "overlap_tick", "on") == "on"),
        host_kv_bytes=getattr(args, "host_kv_bytes", 0),
        device=device, mesh=mesh, **engine_kw)
    if args.model_family == "moe":
        from tpushare_torch.models import moe, quant
        moe_kv = args.kv or "rows"
        if args.preset != "tiny":
            raise SystemExit("--model-family moe serves --preset tiny "
                             "(load real Mixtral trees via the API: "
                             "convert.moe_from_hf + ServeEngine)")
        if args.draft_preset and args.draft_preset != "int8-self":
            raise SystemExit("moe speculative serving supports "
                             "--draft-preset int8-self (the target's "
                             "own int8 rounding; no second model)")
        if args.int8_experts and args.draft_preset == "int8-self":
            # The int8-self draft IS the served int8 target bit for
            # bit: speculation could only add work.
            raise SystemExit(
                "--int8-experts + --draft-preset int8-self: the draft "
                "is bit-identical to the served int8 target, so "
                "speculation can only add work. Serve EITHER int8 "
                "weights (drop --draft-preset) OR int8-self "
                "speculation over bf16 weights (drop --int8-experts)")
        if args.kv_quant:
            raise SystemExit("--kv-quant is a dense-family flag "
                             "(int8 KV pools); --model-family moe "
                             "serves full-precision KV")
        if moe_kv == "rows":
            paged_only = {"--n-blocks": args.n_blocks is not None,
                          "--block-size": args.block_size is not None}
            bad = [k for k, v in paged_only.items() if v]
            if bad:
                raise SystemExit(f"{bad} are paged-pool flags; "
                                 f"--model-family moe --kv rows uses "
                                 f"dense KV rows at --max-len (pass "
                                 f"--kv paged for the block pool)")
        elif args.max_len is not None:
            raise SystemExit("--max-len is a --kv rows flag; paged "
                             "MoE context is --n-blocks x "
                             "--block-size")
        if args.int8_expert_hook and not args.int8_experts:
            raise SystemExit("--int8-expert-hook picks the layers_hook "
                             "for --int8-experts; pass --int8-experts "
                             "(or drop the hook flag)")
        cfg = moe.tiny(remat=False)
        params = moe.init_params(args.seed, cfg, device=device)
        mhook, mspec, mdhook = None, None, None
        if args.draft_preset == "int8-self":
            mspec = (quant.quantize_params(params, cfg), cfg)
            mdhook = quant.fused_expert_hook(cfg)
        if args.int8_experts:
            params = quant.quantize_params(params, cfg)
            mhook = (quant.dequant_hook(cfg)
                     if args.int8_expert_hook == "dequant"
                     else quant.fused_expert_hook(cfg))
        if args.int8_experts and mesh is not None:
            common["param_specs"] = quant.quant_moe_param_specs(cfg)
        if mspec is not None and mesh is not None:
            common["draft_param_specs"] = quant.quant_moe_param_specs(cfg)
        eng = ServeEngine(params, cfg, model_family="moe", kv=moe_kv,
                          max_len=args.max_len or 2048, layers_hook=mhook,
                          speculative_draft=mspec, draft_layers_hook=mdhook,
                          **common)
        del params, mspec
        return _attach_gang_follower(_release_whole(eng), gang_host)
    if args.int8_experts:
        raise SystemExit("--int8-experts is a moe flag; dense int8 "
                         "weights load via the API (quantize_params "
                         "+ layers_hook)")
    if args.int8_expert_hook:
        raise SystemExit("--int8-expert-hook is a moe flag "
                         "(pairs with --int8-experts)")
    if args.kv == "rows":
        raise SystemExit("--kv rows is a moe option; the dense "
                         "family always serves over the paged "
                         "pool")
    if args.max_len is not None:
        raise SystemExit("--max-len is a moe flag; dense context "
                         "is --n-blocks x --block-size")
    from tpushare_torch.models import quant
    from tpushare_torch.models import transformer as tt
    cfg = {"tiny": tt.tiny, "gemma_2b": tt.gemma_2b,
           "llama3_8b": tt.llama3_8b}[args.preset]()
    if getattr(args, "dtype", ""):
        import dataclasses
        cfg = dataclasses.replace(cfg, dtype=getattr(torch, args.dtype))
    if getattr(args, "n_layers", 0):
        import dataclasses
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    params = tt.init_params(args.seed, cfg, device=device)
    spec, hook = None, None
    if args.draft_preset == "int8-self":
        spec = (quant.quantize_params(params, cfg), cfg)
        hook = quant.dequant_hook(cfg)
    elif args.draft_preset:
        dcfg = {"tiny": tt.tiny, "gemma_2b": tt.gemma_2b}[
            args.draft_preset]()
        spec = (tt.init_params(args.seed + 1, dcfg, device=device), dcfg)
    if args.draft_preset == "int8-self" and mesh is not None:
        common["draft_param_specs"] = quant.quant_param_specs(cfg)
    eng = ServeEngine(params, cfg, kv_quant=args.kv_quant,
                      speculative_draft=spec, draft_layers_hook=hook,
                      **common)
    del params, spec
    return _attach_gang_follower(_release_whole(eng), gang_host)


def _launch_probe() -> Dict[str, Any]:
    """The kernel launches each wrapper counted so far in this process
    (a generation's own are the difference from the one before)."""
    from tpushare_torch.tools.multichip import read_launches
    return {"launches": {k: v for k, v in read_launches().items() if v}}


def _liaison_address(init_method: str):
    """The gang liaison's (host, port): one port above the mesh's
    ``tcp://host:port`` rendezvous."""
    host, _, port = init_method[len("tcp://"):].rpartition(":")
    return host or "127.0.0.1", int(port) + 1


def _attach_gang_follower(engine: ServeEngine, gang_host) -> ServeEngine:
    """A mesh engine's generation records carry its kernel launches.
    The first rank of every host past the first heartbeats its host to
    rank 0's liaison, each beat carrying the rank's device-fetch
    counter."""
    mesh = engine._mesh_configured
    if mesh is not None:
        engine.generation_probe = _launch_probe
    if not gang_host or mesh is None or not engine._mesh.process_id:
        return engine
    per_host = mesh.size // engine._topo.num_processes
    pid = engine._mesh.process_id
    if pid % per_host:
        return engine
    from tpushare_torch.parallel.gang import GangFollower
    host, port = _liaison_address(gang_host)
    engine._gang_follower = GangFollower(
        f"{host}:{port}", pid // per_host,
        fetches_fn=lambda: getattr(engine.srv, "device_fetches", 0))
    return engine


def _cli_mesh(args, device, num_processes: int = 1):
    """--mesh/--rank/--dist-init -> a bound ServingMesh (SystemExit
    with the reference's texts on a bad spec, and where its ranks do
    not divide into ``num_processes`` hosts). On the CPU (--device cpu)
    the ranks share the host; otherwise they mesh over the granted
    cards."""
    from tpushare_torch.parallel.mesh import parse_mesh_spec, serving_mesh
    from tpushare_torch.utils.tenant import AllocationError
    try:
        sizes = parse_mesh_spec(args.mesh)
        if args.model_family != "moe" and sizes.get("ep", 1) != 1:
            raise ValueError(
                "ep is expert parallelism (--model-family moe); "
                "the dense family shards over tp")
        mesh = serving_mesh(sizes, devices=(
            [device] if device.type == "cpu" else None))
    except ValueError as e:
        raise SystemExit(
            f"--mesh {args.mesh!r}: {e} (CPU testing recipe: --device "
            f"cpu runs every rank on the host over gloo)")
    except AllocationError as e:
        raise SystemExit(f"--mesh {args.mesh!r}: {e}")
    if mesh.size % num_processes:
        raise SystemExit(
            f"--process-view {num_processes}: the {mesh.size}-rank mesh "
            f"does not divide into {num_processes} hosts")
    if mesh.size > 1 and not args.dist_init:
        raise SystemExit(
            f"--mesh {args.mesh!r} has {mesh.size} ranks: start one "
            f"process per rank, each with --rank and the same "
            f"--dist-init tcp://localhost:<port>")
    if not 0 <= args.rank < mesh.size:
        raise SystemExit(f"--rank {args.rank} is outside the "
                         f"{mesh.size}-rank mesh")
    return mesh.bind(rank=args.rank, init_method=args.dist_init or None)


def _release_whole(engine: ServeEngine) -> ServeEngine:
    """A sharded engine kept only its slices: once the caller has
    dropped the whole tree, hand its cached blocks back to the card,
    which other ranks may share."""
    if engine._mesh is not None and engine.device.type == "cuda":
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    return engine


if __name__ == "__main__":
    raise SystemExit(main())
