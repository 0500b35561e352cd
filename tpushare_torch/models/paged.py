"""Paged KV cache: block-table memory management and the continuous-
batching slot server. Counterpart of ``tpushare/models/paged.py``.

- Pool: [L, n_blocks, block_size, Hkv, Dh] per K/V on the device; the
  last block is the trash block (never on the free list) that inactive
  or unallocated rows write to.
- Block table [n_slots, max_blocks] int32 (-1 = none) and lengths
  [n_slots] int32 on the device, with exact host mirrors
  (``table_np`` / ``lengths_np``) that every scheduling decision reads.
  The host decides every table entry and every length, so a decode
  tick never reads control state back from the card: its one
  device-to-host transfer is the token fetch in ``PendingStep.finalize``.
- Prefix cache: full prompt blocks are published under their chain
  digest (``router/chainkeys.py``); a later admit with the same prefix
  reuses them (refcounted, zero-ref blocks parked on an LRU).
- kv_quant pools: int8 K/V pages plus f32 scale pages
  [L, n_blocks, Hkv, bs] (the port's layout, ``models/quant.py``);
  shared prefix blocks carry their scales along.
- Host tier (``models/kvtier.py``): with one attached, a published block
  an ADMISSION reclaims is demoted to host memory first, and a later
  admission whose chain misses the device index but hits the tier
  promotes it back instead of recomputing it.

Where the JAX version returns new arrays (and donates the old pools to
the jitted step), the port updates the device tensors IN PLACE; the
functions still return the cache for the same call shapes.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.kvtier import CopySpan, HostBlockArena, Payload
from tpushare_torch.models.quant import (init_cache_q8, pool_scales_to_rows,
                                         scales_to_pool_layout)
from tpushare_torch.models.serving import (MultiLoraSlots, PendingStep,
                                           TokenSampler, fused_chunk_span,
                                           fused_token_batch, make_placement,
                                           prompt_host)
from tpushare_torch.models.spec import SpecDecodeMixin
from tpushare_torch.models.transformer import (
    TransformerConfig, forward, init_cache,
)
from tpushare_torch.router.chainkeys import chain_keys


class SlotCapacityExceeded(RuntimeError):
    """One slot's block table is full (its sequence outgrew
    max_blocks x block_size): a per-slot terminal condition. Carries
    ``slot`` so the caller can retire exactly that request."""

    def __init__(self, slot: int, msg: str):
        super().__init__(msg)
        self.slot = slot


class PoolExhausted(RuntimeError):
    """Transient pool/slot pressure: the pool (or the slot array)
    cannot hold this admission right now, but blocks free as
    generations complete."""


class QuotaExceeded(PoolExhausted):
    """A per-tenant KV-block quota verdict (``slo.quota``), not
    pool-wide pressure: ``kind`` is "ceiling" (the tenant's own burst
    cap) or "reserve" (the admission would dig into another tenant's
    floor); ``need`` is the fresh-block count refused."""

    def __init__(self, msg: str, *, kind: str, tenant: str, need: int):
        super().__init__(msg)
        self.kind = kind
        self.tenant = tenant
        self.need = need


@dataclasses.dataclass
class PagedCache:
    """Pool + table state. Device tensors are mutated in place; the
    host mirrors and the prefix bookkeeping are shared host state."""
    pool_k: torch.Tensor        # [L, n_blocks, bs, Hkv, Dh]
    pool_v: torch.Tensor
    block_table: torch.Tensor   # [n_slots, max_blocks] int32 (-1 = none)
    lengths: torch.Tensor       # [n_slots] int32
    block_size: int
    free: List[int]             # host-side free list of pool block ids
    # kv_quant pools: f32 scale pages [L, n_blocks, Hkv, bs]; None for
    # full precision.
    pool_k_scale: Optional[torch.Tensor] = None
    pool_v_scale: Optional[torch.Tensor] = None
    refs: Dict[int, int] = dataclasses.field(default_factory=dict)
    index: Dict[bytes, int] = dataclasses.field(default_factory=dict)
    chains: Dict[int, bytes] = dataclasses.field(default_factory=dict)
    lru: "collections.OrderedDict[int, None]" = dataclasses.field(
        default_factory=collections.OrderedDict)
    table_np: Optional[np.ndarray] = None
    lengths_np: Optional[np.ndarray] = None
    # Host offload tier (models/kvtier.HostKvTier or None), shared like
    # the other host state. A published block reclaimed from the
    # zero-ref LRU under ADMISSION pressure is demoted to it instead of
    # destroyed, and a later admission whose chain misses the device
    # index but hits the tier promotes the blocks back. Growth-path
    # reclaims (_grow_active, inside the step) still destroy, as in the
    # reference: no copy runs inside a decode tick, a fused tick or a
    # speculative round.
    host_tier: Optional[Any] = None
    # blk -> tenant that paid for the block's first write: a demotion
    # charges the tier's byte ledger to it.
    owners: Dict[int, str] = dataclasses.field(default_factory=dict)

    @property
    def n_slots(self) -> int:
        return self.block_table.shape[0]

    @property
    def max_blocks(self) -> int:
        return self.block_table.shape[1]

    def host_table(self) -> np.ndarray:
        """Host truth of the block table (built with one read for a
        hand-constructed cache, exact by construction afterwards)."""
        if self.table_np is None:
            self.table_np = self.block_table.cpu().numpy().copy()
        return self.table_np

    def host_lengths(self) -> np.ndarray:
        if self.lengths_np is None:
            self.lengths_np = self.lengths.cpu().numpy().astype(np.int64)
        return self.lengths_np

    def live_blocks(self) -> int:
        return int((self.host_table() >= 0).sum())

    def set_row(self, slot: int, ids: List[int]) -> None:
        """Write slot's table row (ids then -1) to host and device."""
        tnp = self.host_table()
        tnp[slot, :] = -1
        tnp[slot, :len(ids)] = ids
        self.block_table[slot] = torch.as_tensor(
            tnp[slot], device=self.block_table.device)


def init_paged_cache(cfg: TransformerConfig, *, n_slots: int,
                     n_blocks: int, block_size: int = 16,
                     max_blocks_per_slot: Optional[int] = None,
                     kv_quant: bool = False,
                     device: DeviceLike = None) -> PagedCache:
    """Zeroed pools; the last block is the trash block, left off the
    free list so no slot is ever handed it. ``kv_quant``: int8 pools
    plus f32 scale pages, about half the bytes of bf16 pools."""
    dev = resolve_device(device)
    mb = max_blocks_per_slot or n_blocks
    shape = (cfg.n_layers, n_blocks, block_size, cfg.n_kv_heads,
             cfg.head_dim)
    kv_dtype = torch.int8 if kv_quant else cfg.dtype
    scale_shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, block_size)
    scales = ([torch.zeros(scale_shape, dtype=torch.float32, device=dev)
               for _ in range(2)] if kv_quant else [None, None])
    return PagedCache(
        pool_k=torch.zeros(shape, dtype=kv_dtype, device=dev),
        pool_v=torch.zeros(shape, dtype=kv_dtype, device=dev),
        pool_k_scale=scales[0], pool_v_scale=scales[1],
        block_table=torch.full((n_slots, mb), -1, dtype=torch.int32,
                               device=dev),
        lengths=torch.zeros((n_slots,), dtype=torch.int32, device=dev),
        block_size=block_size,
        free=list(range(n_blocks - 1)),
        table_np=np.full((n_slots, mb), -1, np.int32),
        lengths_np=np.zeros((n_slots,), np.int64),
    )


def blocks_needed(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


def _set_length(cache: PagedCache, slot: int, n: int) -> None:
    cache.host_lengths()[slot] = n
    cache.lengths[slot] = n


def admit(cache: PagedCache, slot: int, n_tokens: int) -> PagedCache:
    """Host-side: reserve blocks for a prompt of ``n_tokens`` (+ room
    for the next token). Raises when the pool is exhausted."""
    need = blocks_needed(n_tokens + 1, cache.block_size)
    if need > cache.max_blocks:
        raise ValueError(f"{n_tokens} tokens exceed slot capacity")
    if need > len(cache.free):
        raise PoolExhausted(
            f"KV pool exhausted: need {need} blocks, {len(cache.free)} free")
    ids = [cache.free.pop() for _ in range(need)]
    cache.set_row(slot, ids)
    _set_length(cache, slot, n_tokens)
    return cache


def grow_if_needed(cache: PagedCache, slot: int) -> PagedCache:
    """Host-side: ensure the slot has a block for position
    lengths[slot]. Reads only the host mirrors."""
    t = int(cache.host_lengths()[slot])
    bi = t // cache.block_size
    if bi >= cache.max_blocks:
        raise SlotCapacityExceeded(slot, f"slot {slot} exceeded max_blocks")
    if int(cache.host_table()[slot, bi]) >= 0:
        return cache
    if not cache.free:
        raise PoolExhausted("KV pool exhausted")
    blk = cache.free.pop()
    cache.host_table()[slot, bi] = blk
    cache.block_table[slot, bi] = blk
    return cache


def evict(cache: PagedCache, slot: int) -> PagedCache:
    """Host-side: return the slot's blocks to the pool (refcount-aware:
    delegates to release())."""
    return release(cache, slot)


def reclaimable_blocks(cache: PagedCache) -> int:
    """Blocks allocatable right now: free list + zero-ref cached."""
    return len(cache.free) + len(cache.lru)


def alloc_blocks(cache: PagedCache, need: int) -> List[int]:
    """Pop ``need`` block ids: free list first, then reclaim the oldest
    zero-ref published blocks (unpublishing them). Raises with the host
    lists intact on a shortfall."""
    if need > reclaimable_blocks(cache):
        raise PoolExhausted(
            f"KV pool exhausted: need {need} blocks, "
            f"{len(cache.free)} free + {len(cache.lru)} reclaimable")
    ids = [cache.free.pop() for _ in range(min(need, len(cache.free)))]
    while len(ids) < need:
        blk, _ = cache.lru.popitem(last=False)          # oldest first
        key = cache.chains.pop(blk)
        cache.index.pop(key, None)
        cache.refs.pop(blk, None)
        ids.append(blk)
    return ids


def _unref(cache: PagedCache, blk: int) -> None:
    """Drop one reference to ``blk``: >0 keep; at zero a published
    block parks on the resident LRU (still hittable), an unpublished
    one returns to the free list."""
    n = cache.refs.get(blk, 1) - 1
    if n > 0:
        cache.refs[blk] = n
        return
    cache.refs.pop(blk, None)
    if blk in cache.chains:
        cache.lru[blk] = None
    else:
        cache.free.append(blk)


def block_layout(cache: PagedCache) -> List[Tuple[str, tuple, Any]]:
    """(field, shape, dtype) of every pool leaf of one block, shaped
    like ``pool[:, blk]``: what a tier payload holds."""
    out = []
    for pf, _ in _row_pairs(cache.pool_k_scale is not None):
        pool = getattr(cache, pf)
        out.append((pf, tuple(pool.shape[:1] + pool.shape[2:]),
                    pool.dtype))
    return out


def attach_host_tier(cache: PagedCache, tier) -> None:
    """Attach ``tier`` to the pool and allocate its host arena once:
    room for the whole byte budget, plus one pool's worth of blocks in
    flight (an admission's demotions are copied before the tier's puts
    evict older entries), plus one for a migrated landing."""
    cache.host_tier = tier
    if tier is None or tier.arena is not None:
        return
    layout = block_layout(cache)
    block_bytes = sum(int(np.prod(shape)) * dtype.itemsize
                      for _, shape, dtype in layout)
    n_slots = (tier.budget_bytes // block_bytes
               + cache.pool_k.shape[1] + 2)
    tier.arena = HostBlockArena(layout, n_slots, cache.pool_k.device)


def host_arena(cache: PagedCache) -> HostBlockArena:
    """The attached tier's arena (allocated here for a tier assigned
    straight to ``cache.host_tier``)."""
    if cache.host_tier.arena is None:
        attach_host_tier(cache, cache.host_tier)
    return cache.host_tier.arena


def _demote_blocks(cache: PagedCache, blks: List[int]) -> None:
    """Copy published blocks to the host tier before a reclaim destroys
    them: each block first passes the crossover policy (``d2h``) and the
    ``kv.demote`` chaos slot — a block that fails either is dropped, the
    plain eviction. The survivors go in ONE gathered copy: a gather of
    every pool leaf into one staging tensor on the card, then one
    asynchronous copy per block into its arena slot, the copies timed by
    CUDA events. The gather is enqueued before the admission's own writes on
    the same stream, so it reads the blocks before their new owner
    overwrites them; no host wait."""
    tier = cache.host_tier
    arena = host_arena(cache)
    bs = cache.block_size
    picked: List[Tuple[int, bytes]] = []
    for blk in blks:
        key = cache.chains.get(blk)
        if key is None:
            continue
        if tier.estimator.decide("d2h", arena.block_bytes, bs) \
                == "recompute":
            continue
        if tier.fault_demote is not None:
            try:
                tier.fault_demote()
            except Exception:
                tier.demote_failures += 1
                continue
        picked.append((blk, key))
    slots: List[int] = []
    for _ in picked:
        s = arena.acquire()
        if s is None:
            break
        slots.append(s)
    if not slots:
        return
    # A full arena keeps the newest blocks, as sequential puts would.
    picked = picked[len(picked) - len(slots):]
    dev = cache.pool_k.device
    stream = torch.cuda.current_stream(dev) if arena.cuda else None
    if stream is not None:
        arena.wait_on_stream(slots, stream)
    ids = torch.tensor([b for b, _ in picked], device=dev)
    rows = torch.empty((len(picked), arena.slot_bytes), dtype=torch.uint8,
                       device=dev)
    for pf, view in arena.leaves(rows).items():
        view.copy_(getattr(cache, pf).index_select(1, ids).transpose(0, 1))
    # The d2h channel times the copies over the bus, not the gather.
    span = CopySpan(dev, stream)
    for i, s in enumerate(slots):
        arena.buf[s].copy_(rows[i], non_blocking=True)
    arena.fence(slots, span.close(tier.estimator, "d2h",
                                  len(slots) * arena.block_bytes))
    for (blk, key), s in zip(picked, slots):
        if not tier.put(key, arena.payload(s), tenant=cache.owners.get(blk),
                        tokens=bs, kind="demote"):
            arena.release(s)


def demote_for_alloc(cache: PagedCache, need: int) -> None:
    """Demote the zero-ref LRU blocks an allocation of ``need`` is about
    to reclaim (oldest first, the order alloc_blocks consumes them).
    Pure copy: the reclaim still runs through alloc_blocks unchanged, so
    a failed or refused demotion degrades to destroy-and-recompute."""
    if cache.host_tier is None:
        return
    shortfall = need - len(cache.free)
    if shortfall <= 0:
        return
    _demote_blocks(cache, list(cache.lru)[:shortfall])


def admit_prefix(cache: PagedCache, slot: int, prompt: np.ndarray,
                 keys: Optional[List[bytes]] = None
                 ) -> Tuple[PagedCache, int, List[int]]:
    """Reserve the slot's blocks, reusing every published block whose
    chain matches the prompt's prefix. Returns (cache, cached_len,
    blocks): the caller prefills only positions >= cached_len.
    Matching stops at (S-1)//bs full blocks, so the tail block decode
    writes into is always fresh, and at the first chain miss. With a
    host tier attached the match continues into the tier: consecutive
    tier-resident chain blocks are PROMOTED into freshly allocated pool
    blocks (a host-to-device copy, never a fetch) and count toward
    cached_len."""
    S = int(prompt.shape[0])
    bs = cache.block_size
    need_total = blocks_needed(S + 1, bs)
    if need_total > cache.max_blocks:
        raise ValueError(f"{S} tokens exceed slot capacity")
    if keys is None:
        keys = chain_keys(prompt, bs, (S - 1) // bs)
    tier = cache.host_tier
    if tier is not None:
        tier.last_promoted_n = 0
    matched: List[int] = []
    for key in keys[:(S - 1) // bs]:
        blk = cache.index.get(key)
        if blk is None:
            break
        matched.append(blk)
    # Continue into the tier; stop at a key the device index holds after
    # all (a stale tier copy would publish a duplicate chain) and at the
    # tier's own gate (chaos, the crossover policy, not resident).
    promote_keys: List[bytes] = []
    if tier is not None:
        for key in keys[len(matched):(S - 1) // bs]:
            if key in cache.index:
                break
            if not tier.begin_promote(key, tokens=bs):
                break
            promote_keys.append(key)
    # Pin the matched blocks BEFORE allocating: an unpinned match on
    # the zero-ref LRU could be handed out as "fresh".
    for b in matched:
        cache.refs[b] = cache.refs.get(b, 0) + 1
        cache.lru.pop(b, None)
    try:
        n_need = need_total - len(matched)
        # Demote what this allocation is about to reclaim: eviction
        # becomes demotion, on this path only.
        demote_for_alloc(cache, n_need)
        fresh = alloc_blocks(cache, n_need)
    except RuntimeError:
        for b in reversed(matched):          # leaf-first, as release()
            _unref(cache, b)
        raise
    for b in fresh:
        cache.refs[b] = 1
    n_landed = 0
    if promote_keys:
        n_landed = _land_promoted(cache, promote_keys,
                                  fresh[:len(promote_keys)])
        tier.last_promoted_n = n_landed
    row = matched + fresh
    cache.set_row(slot, row)
    _set_length(cache, slot, S)
    return cache, (len(matched) + n_landed) * bs, row


def _land_promoted(cache: PagedCache, keys: List[bytes],
                   blk_ids: List[int]) -> int:
    """Write promoted tier blocks into freshly allocated pool blocks and
    publish them; returns how many landed. Host-to-device only: one
    asynchronous copy per block from its arena slot (a prefetched block
    is already on the card: a device copy after the prefetch's event),
    then one scatter per pool leaf. An entry that vanished or fails
    validation breaks the chain there; the caller prefills the rest.
    The uploads (not the scatter) are timed for the ``h2d`` channel."""
    tier = cache.host_tier
    arena = host_arena(cache)
    shapes = {pf: shape for pf, shape, _ in arena.layout}
    datas = []
    for key in keys:
        data, staged = tier.take_promote(key)
        if (data is None or set(data) != set(shapes)
                or any(tuple(data[pf].shape) != shapes[pf]
                       for pf in shapes)):
            break
        datas.append((data, staged))
    if not datas:
        return 0
    n = len(datas)
    dev = cache.pool_k.device
    stream = torch.cuda.current_stream(dev) if arena.cuda else None
    host_slots = [d.slot for d, staged in datas
                  if not staged and getattr(d, "slot", None) is not None]
    if stream is not None:
        arena.wait_on_stream(host_slots, stream)
        for d, staged in datas:
            if staged and getattr(d, "event", None) is not None:
                stream.wait_event(d.event)
    span = CopySpan(dev, stream)
    rows = torch.empty((n, arena.slot_bytes), dtype=torch.uint8, device=dev)
    views = arena.leaves(rows)
    host_bytes = 0
    for i, (d, staged) in enumerate(datas):
        src = getattr(d, "row", None)
        if src is not None:
            rows[i].copy_(src, non_blocking=True)
            if staged and stream is not None:
                src.record_stream(stream)    # allocated on the side stream
        else:
            for pf in shapes:
                views[pf][i].copy_(d[pf], non_blocking=True)
        if not staged:
            host_bytes += sum(int(t.nbytes) for t in d.values())
    if host_bytes:
        arena.fence(host_slots,
                    span.close(tier.estimator, "h2d", host_bytes))
    ids = torch.tensor(blk_ids[:n], device=dev)
    for pf, view in views.items():
        getattr(cache, pf)[:, ids] = view.transpose(0, 1)
    for key, blk in zip(keys[:n], blk_ids[:n]):
        if key not in cache.index and blk not in cache.chains:
            cache.index[key] = blk
            cache.chains[blk] = key
    return n


def publish_prefix(cache: PagedCache, blocks: List[int],
                   prompt: np.ndarray,
                   keys: Optional[List[bytes]] = None) -> None:
    """Index the slot's freshly filled full prompt blocks so later
    admits can share them (host dicts only; first writer wins)."""
    S = int(prompt.shape[0])
    bs = cache.block_size
    n_pub = S // bs
    if keys is None:
        keys = chain_keys(prompt, bs, n_pub)
    for i, key in enumerate(keys[:n_pub]):
        blk = int(blocks[i])
        if blk in cache.chains or key in cache.index:
            continue
        cache.index[key] = blk
        cache.chains[blk] = key


def release(cache: PagedCache, slot: int) -> PagedCache:
    """Refcount-aware evict. Blocks park LEAF-FIRST (reversed table
    order) so reclaim, which pops the LRU oldest-first, eats a chain
    from its leaf and the surviving prefix stays matchable."""
    for b in reversed(cache.host_table()[slot]):
        b = int(b)
        if b >= 0:
            _unref(cache, b)
    cache.set_row(slot, [])
    _set_length(cache, slot, 0)
    return cache


def _paged_cache(pool_k, pool_v, table, active, pool_k_scale, pool_v_scale):
    c = {"pool_k": pool_k, "pool_v": pool_v, "table": table,
         "active": active}
    if pool_k_scale is not None:
        c["pool_k_scale"] = pool_k_scale
        c["pool_v_scale"] = pool_v_scale
    return c


def decode_core(params, tokens, pool_k, pool_v, table, lengths, active,
                *, cfg: TransformerConfig, attn_impl: str = "auto",
                layers_hook=None, pool_k_scale=None, pool_v_scale=None,
                forward_fn=None, mlora_idx=None, mlora_scale: float = 1.0):
    """One paged decode step over the pools: tokens [B, 1]; active [B]
    bool. Each layer writes its new KV into its pool slice in place and
    attends through the block table (forward's paged S=1 branch).
    ``forward_fn``: a ``transformer.forward``-shaped callable with a
    paged branch (``moe.paged_forward`` serves the MoE family over the
    same pool); default the dense LM's forward. ``mlora_idx`` [B]: each
    row's multi-LoRA adapter (the bank rides in ``params``). Returns
    (logits [B, 1, V], pool_k, pool_v, lengths advanced by 1 for active
    slots)."""
    logits, _ = (forward_fn or forward)(params, tokens, cfg,
                        cache=_paged_cache(pool_k, pool_v, table, active,
                                           pool_k_scale, pool_v_scale),
                        pos_offset=lengths, attn_impl=attn_impl,
                        layers_hook=layers_hook, mlora_idx=mlora_idx,
                        mlora_scale=mlora_scale)
    return logits, pool_k, pool_v, lengths + active.to(lengths.dtype)


def paged_decode_step(params, tokens: torch.Tensor, cfg: TransformerConfig,
                      cache: PagedCache, *,
                      active: Optional[torch.Tensor] = None,
                      attn_impl: str = "auto"
                      ) -> Tuple[torch.Tensor, PagedCache]:
    """One ragged decode step over the paged pool: tokens [n_slots, 1]
    -> (logits [n_slots, 1, V], cache). Through ``decode_core``, as the
    servers' ticks go; the pools and lengths are updated in place.

    ``active`` [n_slots] bool masks which slots advance — inactive
    slots keep their length and write only to the trash block (default:
    all active, made on the device: the step then neither reads nor
    uploads anything). The host lengths mirror advances by the same +1
    per active slot before dispatch, so ``grow_if_needed`` (which reads
    only the mirror) sees the post-step truth. This module-level
    wrapper reads a device ``active`` back to the host (and uploads a
    host one); the servers never go through it — they drive
    ``decode_core`` directly and keep their mirrors from the host
    active bitmap."""
    dev = cache.lengths.device
    if active is None:
        act_np = np.ones((cache.n_slots,), bool)
        active = torch.ones((cache.n_slots,), dtype=torch.bool, device=dev)
    else:
        act_np = np.asarray(active.cpu() if isinstance(active, torch.Tensor)
                            else active, dtype=bool)
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
    cache.host_lengths()[act_np] += 1
    logits, _, _, cache.lengths = decode_core(
        params, tokens, cache.pool_k, cache.pool_v, cache.block_table,
        cache.lengths, active, cfg=cfg, attn_impl=attn_impl,
        pool_k_scale=cache.pool_k_scale, pool_v_scale=cache.pool_v_scale)
    return logits, cache


def verify_core(params, tokens, pool_k, pool_v, table, lengths, active,
                *, cfg: TransformerConfig, attn_impl: str = "auto",
                layers_hook=None, pool_k_scale=None, pool_v_scale=None,
                forward_fn=None, mlora_idx=None, mlora_scale: float = 1.0):
    """Multi-token paged forward (speculative verify, fused tick):
    tokens [B, Sq] are written at positions lengths .. lengths+Sq-1 of
    each active slot (the pools in place) and scored in one forward.
    Returns logits [B, Sq, V]; lengths are NOT advanced (the caller
    decides acceptance first; rejected positions leave stale KV the
    length mask keeps unattended until it is overwritten).
    ``forward_fn`` and ``mlora_idx`` as ``decode_core``."""
    logits, _ = (forward_fn or forward)(params, tokens, cfg,
                        cache=_paged_cache(pool_k, pool_v, table, active,
                                           pool_k_scale, pool_v_scale),
                        pos_offset=lengths, attn_impl=attn_impl,
                        layers_hook=layers_hook, mlora_idx=mlora_idx,
                        mlora_scale=mlora_scale)
    return logits


def prefill_into(params, prompt: torch.Tensor, cfg: TransformerConfig,
                 cache: PagedCache, slot: int, attn_impl: str = "auto",
                 forward_fn=None) -> Tuple[torch.Tensor, PagedCache]:
    """Prefill one prompt [S] and write its KV into the slot's blocks.
    Returns (last-position logits [V], cache). The ``cached_len == 0``
    case of ``prefill_suffix_into``."""
    return prefill_suffix_into(params, prompt, cfg, cache, slot, 0,
                               attn_impl=attn_impl, forward_fn=forward_fn)


def prefill_suffix_into(params, prompt: torch.Tensor,
                        cfg: TransformerConfig, cache: PagedCache,
                        slot: int, cached_len: int,
                        attn_impl: str = "auto", forward_fn=None
                        ) -> Tuple[torch.Tensor, PagedCache]:
    """Prefix-cached prefill: compute KV only for positions >=
    ``cached_len``, attending over the shared prefix gathered from the
    pool, and write only the slot's fresh blocks. Returns
    (last-position logits [V], cache)."""
    S = int(prompt.shape[0])
    row, comp_len, n_blk = _admission_row(cfg, cache, slot, S, cached_len)
    last, cache, _ = _prefill_chunk(params, prompt, cfg, cache, slot, row,
                                    cached_len, S, n_blk, comp_len,
                                    chunk=0, attn_impl=attn_impl,
                                    forward_fn=forward_fn)
    return last, cache


def _row_pairs(kvq: bool):
    """(pool field, row-cache key) of every leaf the gather/scatter
    moves; the scale leaves change layout on the way."""
    pairs = [("pool_k", "k"), ("pool_v", "v")]
    if kvq:
        pairs += [("pool_k_scale", "k_scale"), ("pool_v_scale", "v_scale")]
    return pairs


def admission_len(S: int, cached_len: int, block_size: int,
                  max_blocks: int) -> Tuple[int, int]:
    """(n_blk, comp_len) of a whole-prompt admission of S tokens with
    ``cached_len`` of them reused: comp_len pads the fresh part to a
    power-of-two block count, as the reference does. The admission's
    attention runs Sq = comp_len - cached_len queries at q_offset
    ``cached_len`` over Sk = comp_len keys."""
    n_blk = blocks_needed(S + 1, block_size)
    cached_blk = cached_len // block_size
    fresh_blk = n_blk - cached_blk
    comp_fresh = max(1, 1 << (fresh_blk - 1).bit_length())   # pow2 bucket
    comp_fresh = max(min(comp_fresh, max_blocks - cached_blk), fresh_blk)
    return n_blk, cached_len + comp_fresh * block_size


def _admission_row(cfg: TransformerConfig, cache: PagedCache, slot: int,
                   S: int, cached_len: int):
    """The dense row cache one admission computes into (int8 rows with
    row-major scales for a kv_quant pool), with the [0, cached_len)
    prefix gathered from the pool once. Returns (row, comp_len,
    n_blk)."""
    bs = cache.block_size
    n_blk, comp_len = admission_len(S, cached_len, bs, cache.max_blocks)
    cached_blk = cached_len // bs
    kvq = cache.pool_k_scale is not None
    make = init_cache_q8 if kvq else init_cache
    row = make(cfg, 1, comp_len, device=cache.pool_k.device)
    if cached_blk:
        L = row["k"].shape[0]
        blk_ids = cache.block_table[slot, :cached_blk].long()
        for pf, rk in _row_pairs(kvq):
            g = getattr(cache, pf)[:, blk_ids]     # [L, cached_blk, ...]
            if pf.endswith("_scale"):
                g = pool_scales_to_rows(g)         # -> [L, cb, bs, Hkv]
            row[rk][:, 0, :cached_len] = g.reshape(L, cached_len,
                                                   *g.shape[3:])
    return row, comp_len, n_blk


def _prefill_chunk(params, prompt: torch.Tensor, cfg: TransformerConfig,
                   cache: PagedCache, slot: int, row, done: int, end: int,
                   n_blk: int, comp_len: int, chunk: int,
                   attn_impl: str = "auto", layers_hook=None,
                   forward_fn=None, mlora=None):
    """Forward prompt positions [done, end) against the admission row
    (which already holds [0, done)) and write this chunk's block rows
    to the pool. ``mlora``: the admission's adapter kwargs
    (``MultiLoraSlots.kw``). Returns (last-position logits [V] on the
    final chunk else None, cache, row).

    Padding follows the reference: mid chunks run at the fixed
    ``chunk`` length, the final chunk pads to the row tail — the padded
    tail writes junk KV into the last block, which decode's length mask
    never attends and the first decode write at position S overwrites.
    The full [1, pad_len, V] f32 logits are computed, as there."""
    S = int(prompt.shape[0])
    bs = cache.block_size
    final = end >= S
    pad_len = (comp_len - done) if final else chunk
    padded = torch.zeros((pad_len,), dtype=prompt.dtype,
                         device=prompt.device)
    padded[:end - done] = prompt[done:end]
    logits, row = (forward_fn or forward)(
        params, padded[None, :], cfg, cache=row, pos_offset=done,
        attn_impl=attn_impl, layers_hook=layers_hook, **(mlora or {}))
    start_blk = done // bs
    end_blk = n_blk if final else end // bs
    ids = cache.block_table[slot, start_blk:end_blk].long()
    L = row["k"].shape[0]
    n_fresh = end_blk - start_blk
    for pf, rk in _row_pairs(cache.pool_k_scale is not None):
        r = row[rk][:, 0, start_blk * bs:end_blk * bs]
        r = r.reshape(L, n_fresh, bs, *r.shape[2:])
        if pf.endswith("_scale"):
            r = scales_to_pool_layout(r)           # -> [L, fb, Hkv, bs]
        # In-place scatter into the pool (the reference's donated
        # .at[:, ids].set).
        getattr(cache, pf)[:, ids] = r
    last = logits[0, S - 1 - done] if final else None
    return last, cache, row


class PagedSlotServer(SpecDecodeMixin):
    """Continuous batching over the paged pool: admit / step / evict.

    Host/device split as in the reference: the host owns the free
    list, the active bitmap and exact mirrors of the block table and
    lengths; every tick costs exactly ONE device-to-host transfer (the
    sampled tokens; on a speculative round the drafts, corrections and
    accepted counts in one packed tensor), made in
    ``PendingStep.finalize``. Growth and capacity retirement read the
    mirrors.

    Options ported: greedy sampling, ``prefix_cache``, chunked
    admission, the fused admission tick (``step(prefill_work=slot)``),
    ``kv_quant`` (int8 pools), ``layers_hook`` (int8 weights), and
    speculative decoding (``speculative_draft=(params, cfg)``,
    ``gamma``, ``spec_horizon``, ``draft_layers_hook``: the
    ``int8-self`` preset is ``(quant.quantize_params(params, cfg), cfg)``
    with ``quant.dequant_hook(cfg)``), ``forward_fn`` (another family's
    forward over the same pool: ``moe.paged_forward`` serves the MoE LM,
    its drafts too unless ``draft_forward_fn`` names the draft's own;
    not with ``kv_quant`` or ``multi_lora``, whose branches live in the
    dense LM's forward, as in the reference), ``multi_lora`` (an adapter
    bank, ``lora.stack_adapters``: each slot picks its adapter at
    ``admit(prompt, adapter=i)``; prefix chains are salted with the
    adapter id; a speculative server's draft carries the same bank),
    sampling (temperature, top-k, top-p; stochastic speculation by the
    exact rejection rule), and
    ``kv_quota`` (a ``slo.KvQuota``: fresh blocks charged to the
    admitting tenant at admission, shared prefix hits free, growth
    charged, every charge refunded on evict), and ``host_tier`` (a
    ``kvtier.HostKvTier``: admissions demote the published blocks they
    reclaim and promote tier-resident chains; ``prefetch_prefix`` stages
    a prompt's tier blocks on the card ahead of its admission), and
    ``mesh`` (a bound ``parallel.mesh.ServingMesh``, reference
    ``:903-949, 1072``): weights per ``param_specs`` (default the
    family's full-precision tree, off the config's shape), both pools
    of this rank's kv heads, block table / lengths / free list
    replicated host decisions; a speculative draft places per its own
    ``draft_param_specs`` on the same kv-head split. Not with kv_quant,
    multi_lora or a host tier, as the reference refuses them. On a mesh
    ``cfg`` is the rank's geometry and ``model_cfg`` the whole model's.
    """

    def __init__(self, params, cfg: TransformerConfig, *, n_slots: int,
                 n_blocks: int, block_size: int = 16,
                 max_blocks_per_slot: Optional[int] = None,
                 attn_impl: str = "auto", layers_hook=None,
                 prefix_cache: bool = False,
                 kv_quant: bool = False,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0,
                 multi_lora=None, mlora_scale: float = 1.0,
                 speculative_draft=None, gamma: int = 4,
                 spec_horizon: int = 1, draft_layers_hook=None,
                 forward_fn=None, draft_forward_fn=None, mesh=None,
                 param_specs=None, draft_param_specs=None,
                 kv_quota=None, host_tier=None, device: DeviceLike = None):
        if forward_fn is not None and (kv_quant or multi_lora is not None):
            raise ValueError("forward_fn overrides (paged MoE) do not "
                             "support kv_quant or multi_lora: those "
                             "branches live in the dense LM's forward")
        self.mesh = mesh
        self.model_cfg = cfg
        if mesh is not None and (kv_quant or multi_lora is not None):
            raise ValueError(
                "mesh sharding does not compose with kv_quant/"
                "multi_lora yet (the int8 scale pools' padded-head "
                "layout and the adapter bank have no sharded "
                "placement contract — documented seams)")
        if mesh is not None and host_tier is not None:
            raise ValueError(
                "host_kv_bytes does not compose with mesh sharding yet "
                "(a sharded pool's block rows are split across ranks; "
                "the host copy/restore contract here is single-device "
                "— documented seam, like kv_quant-on-mesh)")
        self._placement = make_placement(mesh, cfg, param_specs)
        if self._placement is not None:
            params = self._placement.place_params(params)
            cfg = self._placement.local_cfg(cfg)
            device = self._placement.device
            forward_fn = self._placement.forward_fn(forward_fn or forward)
            if draft_forward_fn is None and speculative_draft is not None:
                draft_forward_fn = forward_fn.__wrapped__
        self.device = resolve_device(device)
        if multi_lora is not None:
            from tpushare_torch.models.lora import multi_lora_params
            params = multi_lora_params(params, multi_lora)
        self._ml = MultiLoraSlots(multi_lora, n_slots, mlora_scale,
                                  self.device)
        self.params = params
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.layers_hook = layers_hook
        self._forward_fn = forward_fn
        self._sampler = TokenSampler(temperature, top_k, top_p, seed,
                                     device=self.device)
        # kv_quant lives entirely in the cache (int8 pools + scale
        # pages); every path branches off cache.pool_k_scale.
        self.cache = init_paged_cache(
            cfg, n_slots=n_slots, n_blocks=n_blocks, block_size=block_size,
            max_blocks_per_slot=max_blocks_per_slot, kv_quant=kv_quant,
            device=self.device)
        if host_tier is not None:
            attach_host_tier(self.cache, host_tier)
        # Side stream of the host tier's prefetch uploads (made on the
        # first prefetch on a card).
        self._h2d_stream = None
        # Device->host transfers made by admissions and ticks.
        self.device_fetches = 0
        self.prefix_cache = prefix_cache
        self.last_cached_len = 0            # tokens reused by last admit
        self.prefix_hit_tokens = 0          # cumulative reused tokens
        self.prefix_prompt_tokens = 0       # cumulative admitted tokens
        self.active = np.zeros(n_slots, dtype=bool)            # host truth
        self._active_dev = torch.zeros((n_slots,), dtype=torch.bool,
                                       device=self.device)      # mirror
        self._admissions: Dict[int, Dict[str, Any]] = {}
        # Per-tenant KV-block quotas (None = unquota'd pool). The server
        # is the ledger's one writer; _slot_charge holds each slot's
        # balance so the refund at evict is exact. Host state only.
        self.kv_quota = kv_quota
        self._slot_tenant: Dict[int, str] = {}
        self._slot_charge: Dict[int, int] = {}
        self.last_token = torch.zeros((n_slots, 1), dtype=torch.int64,
                                      device=self.device)
        # Speculative decoding: the draft keeps its own pools, bf16 even
        # when the target's are int8, indexed by the SAME block table
        # (shared prefix blocks carry draft KV written by their
        # publisher: identical values for identical tokens).
        self.speculative = speculative_draft is not None
        self.gamma = gamma
        self.spec_horizon = spec_horizon
        if self.speculative:
            self._spec_init(gamma=gamma, spec_horizon=spec_horizon,
                            temperature=temperature, top_k=top_k,
                            top_p=top_p)
            draft_params, draft_cfg = speculative_draft
            if draft_cfg.vocab_size != cfg.vocab_size:
                raise ValueError("draft and target must share a vocab")
            if self._ml.enabled:
                # The draft carries the SAME bank, so each slot's
                # proposals come from its own fine-tune; the bank's A/B
                # shapes only fit a draft of the target's geometry.
                geom = ("d_model", "n_layers", "n_heads", "n_kv_heads",
                        "head_dim", "d_ff")
                if any(getattr(draft_cfg, a) != getattr(cfg, a)
                       for a in geom):
                    raise NotImplementedError(
                        "speculative + multi_lora needs a draft sharing "
                        "the target's layer geometry (int8-self or a "
                        "same-architecture draft) so the adapter bank "
                        "applies to both sides")
                from tpushare_torch.models.lora import multi_lora_params
                draft_params = multi_lora_params(draft_params, multi_lora)
            dplace = make_placement(mesh, draft_cfg, draft_param_specs,
                                    role="draft")
            if dplace is not None:
                # The draft places like the target on the same kv-head
                # split: the shared block table indexes both pools.
                draft_params = dplace.place_params(draft_params)
                draft_cfg = dplace.local_cfg(draft_cfg)
            self.draft_params, self.draft_cfg = draft_params, draft_cfg
            self.draft_layers_hook = draft_layers_hook
            # The draft's forward: its own family's, or the target's
            # (int8-self MoE drafts ride moe.paged_forward too).
            self._draft_forward_fn = (forward_fn if draft_forward_fn is None
                                      else draft_forward_fn)
            if dplace is not None:
                self._draft_forward_fn = dplace.forward_fn(
                    self._draft_forward_fn)
            dshape = (self.draft_cfg.n_layers, n_blocks, block_size,
                      self.draft_cfg.n_kv_heads, self.draft_cfg.head_dim)
            self._dpk = torch.zeros(dshape, dtype=self.draft_cfg.dtype,
                                    device=self.device)
            self._dpv = torch.zeros(dshape, dtype=self.draft_cfg.dtype,
                                    device=self.device)

    @property
    def slot_capacity(self) -> int:
        return self.cache.max_blocks * self.cache.block_size

    def _sync_active(self) -> None:
        """Host bitmap -> device mirror (an upload, never a fetch). A
        copy even on the CPU, so later edits of the host array never
        reach the mirror."""
        self._active_dev = torch.tensor(self.active, device=self.device)

    def _draft_view(self) -> PagedCache:
        """The draft pools behind the slots' own block table."""
        return dataclasses.replace(self.cache, pool_k=self._dpk,
                                   pool_v=self._dpv, pool_k_scale=None,
                                   pool_v_scale=None)

    def _pool_kw(self) -> Dict[str, Any]:
        c = self.cache
        return {"cfg": self.cfg, "attn_impl": self.attn_impl,
                "layers_hook": self.layers_hook,
                "pool_k_scale": c.pool_k_scale,
                "pool_v_scale": c.pool_v_scale,
                "forward_fn": self._forward_fn}

    def _draft_kw(self) -> Dict[str, Any]:
        return {"cfg": self.draft_cfg, "attn_impl": self.attn_impl,
                "layers_hook": self.draft_layers_hook,
                "forward_fn": self._draft_forward_fn}

    def admit(self, prompt, adapter: int = -1,
              tenant: Optional[str] = None) -> int:
        """Reserve blocks for ``prompt`` [S], prefill them, return the
        slot. Raises PoolExhausted when slots or pool blocks run out,
        QuotaExceeded when ``tenant``'s KV quota refuses them."""
        slot = self.admit_start(prompt, adapter=adapter, tenant=tenant)
        while self.admit_step(slot) is None:
            pass
        return slot

    def admit_start(self, prompt, adapter: int = -1,
                    chunk_tokens: Optional[int] = None,
                    tenant: Optional[str] = None) -> int:
        """Reserve a slot and all its blocks for ``prompt`` without
        prefilling yet; drive the prefill with admit_step() or with
        fused ticks (``step(prefill_work=slot)``). With ``chunk_tokens``
        the prompt prefills in block-aligned chunks, each attending over
        the admission's row (bit-identical KV to a whole-prompt
        admit). ``tenant`` is the KV-quota principal (None = "default");
        ``adapter`` the slot's multi-LoRA bank index (-1 = base)."""
        prompt_np = prompt_host(prompt)
        if prompt_np.ndim != 1:
            raise ValueError("admit takes a single unbatched prompt")
        self._ml.validate(adapter)
        candidates = [s for s in range(self.cache.n_slots)
                      if not self.active[s] and s not in self._admissions]
        if not candidates:
            raise PoolExhausted("no free slots")
        slot = candidates[0]
        self._ml.set(slot, adapter)
        # A slot that retired at capacity still owns its blocks;
        # release them before reuse or they leak.
        if (self.cache.host_table()[slot] >= 0).any():
            self._refund_slot(slot)
            self.cache = release(self.cache, slot)
        S = int(prompt_np.shape[0])
        bs = self.cache.block_size
        tenant = tenant or "default"
        if self.prefix_cache:
            # Salted by adapter id: KV under different adapters must
            # never share blocks.
            keys = chain_keys(prompt_np, bs, S // bs,
                              salt=self._adapter_salt(adapter))
            self.cache, cached_len, blocks = admit_prefix(
                self.cache, slot, prompt_np, keys=keys)
            self.last_cached_len = cached_len
            self.prefix_hit_tokens += cached_len
            self.prefix_prompt_tokens += S
        else:
            self.cache = admit(self.cache, slot, S)
            cached_len, keys, blocks = 0, None, None
        tier = self.cache.host_tier if self.prefix_cache else None
        promoted = tier.last_promoted_n if tier is not None else 0
        if self.kv_quota is not None:
            # Charge the FRESH allocation only (prefix hits share blocks
            # their first writer paid for). The verdict sees the
            # post-admission pool (admit_verdict subtracts ``fresh``); a
            # refusal rolls the host-side reservation back intact.
            # Promoted tier landings count as cached_len for prefill but
            # are fresh device blocks the tenant pays for.
            fresh = blocks_needed(S + 1, bs) - cached_len // bs + promoted
            verdict = self.kv_quota.admit_verdict(
                tenant, fresh, reclaimable_blocks(self.cache) + fresh)
            if verdict is not None:
                kind, msg = verdict
                self.cache = release(self.cache, slot)
                if self.prefix_cache:
                    self.prefix_hit_tokens -= cached_len
                    self.prefix_prompt_tokens -= S
                raise QuotaExceeded(msg, kind=kind, tenant=tenant,
                                    need=fresh)
            self.kv_quota.charge(tenant, fresh)
            self._slot_charge[slot] = fresh
        self._slot_tenant[slot] = tenant
        if tier is not None:
            # This tenant is the quota principal of every freshly
            # allocated block: a later demotion charges the tier's byte
            # ledger to it.
            for b in blocks[cached_len // bs - promoted:]:
                self.cache.owners[int(b)] = tenant
        chunk = chunk_tokens if chunk_tokens else S
        chunk = max(bs, -(-chunk // bs) * bs)     # round UP to blocks
        row, comp_len, n_blk = _admission_row(
            self.cfg, self.cache, slot, S, cached_len)
        st = {
            "prompt": torch.as_tensor(prompt_np, device=self.device),
            "prompt_np": prompt_np, "done": cached_len, "chunk": chunk,
            "keys": keys, "blocks": blocks,
            "row": row, "comp_len": comp_len, "n_blk": n_blk,
            # Fused chunks write straight to the pool; the serial row
            # then lags it and is re-gathered before the next serial
            # chunk.
            "row_stale": False, "mlora": self._ml.kw(adapter),
        }
        if self.speculative:
            st["drow"], st["dcomp_len"], _ = _admission_row(
                self.draft_cfg, self._draft_view(), slot, S, cached_len)
        self._admissions[slot] = st
        return slot

    def admit_step(self, slot: int,
                   max_chunk_tokens: Optional[int] = None
                   ) -> Optional[int]:
        """Prefill the next chunk of a started admission (capped at
        ``max_chunk_tokens`` rounded down to blocks, floor one block).
        Returns None while chunks remain; on the final chunk, samples
        the first token (one device-to-host fetch), activates the slot
        and returns the token."""
        st = self._admissions[slot]
        S = int(st["prompt_np"].shape[0])
        chunk = st["chunk"]
        if max_chunk_tokens is not None:
            bs = self.cache.block_size
            chunk = max(bs, min(chunk, (max_chunk_tokens // bs) * bs))
        if st["row_stale"]:
            # Fused chunks advanced this admission pool-side: rebuild
            # the serial rows from the pool (what _admission_row does
            # for a prefix hit of length `done`).
            st["row"], st["comp_len"], _ = _admission_row(
                self.cfg, self.cache, slot, S, st["done"])
            if self.speculative:
                st["drow"], st["dcomp_len"], _ = _admission_row(
                    self.draft_cfg, self._draft_view(), slot, S,
                    st["done"])
            st["row_stale"] = False
        end = min(S, st["done"] + chunk)
        done0 = st["done"]
        # Crossover-estimator feed: the final chunk's span ends at the
        # blocking token fetch below (device time included); mid-chunk
        # spans are launch-only and bias the measured prefill rate HIGH,
        # i.e. the policy toward recompute, as in the reference.
        t0 = time.perf_counter()
        last_logits, self.cache, st["row"] = _prefill_chunk(
            self.params, st["prompt"], self.cfg, self.cache, slot,
            st["row"], st["done"], end, st["n_blk"], st["comp_len"],
            chunk, attn_impl=self.attn_impl, layers_hook=self.layers_hook,
            forward_fn=self._forward_fn, mlora=st["mlora"])
        if self.speculative:
            # The draft needs the prompt's KV too, chunked the same way
            # (its pools are written in place through the view).
            _, _, st["drow"] = _prefill_chunk(
                self.draft_params, st["prompt"], self.draft_cfg,
                self._draft_view(), slot, st["drow"], st["done"], end,
                st["n_blk"], st["dcomp_len"], chunk,
                attn_impl=self.attn_impl,
                layers_hook=self.draft_layers_hook,
                forward_fn=self._draft_forward_fn, mlora=st["mlora"])
        st["done"] = end
        tier = self.cache.host_tier
        if end < S:
            if tier is not None:
                tier.estimator.observe_prefill(
                    end - done0, time.perf_counter() - t0)
            return None
        del self._admissions[slot]
        if self.prefix_cache:
            publish_prefix(self.cache, st["blocks"], st["prompt_np"],
                           keys=st["keys"])
        nxt = self._sampler.pick(last_logits[None, :])[0]
        self.last_token[slot, 0] = nxt
        self.active[slot] = True
        self._sync_active()
        self.device_fetches += 1
        tok = int(nxt.item())  # tpushare: ignore[TS103] the one token fetch
        if tier is not None:
            tier.estimator.observe_prefill(
                end - done0, time.perf_counter() - t0)
        return tok

    def prefetch_prefix(self, prompt_np: np.ndarray,
                        adapter: int = -1) -> int:
        """Stage the host-tier part of ``prompt_np``'s chain on the card
        AHEAD of its admission: the engine calls this inside the
        overlapped tick's flight window, so the upload runs on a side
        stream beside the dispatch in flight, and the admission's
        promotion finds the blocks on the card (waiting only on the
        upload's event). Host-to-device only: no fetch. Returns the
        number of chain blocks staged.

        Mirrors admit_prefix's walk: the device-matched prefix needs no
        upload, the consecutive tier run after it stages, the first
        miss (or an index hit after the run started) ends it. Stale
        stages are dropped here."""
        tier = self.cache.host_tier
        if tier is None or not self.prefix_cache:
            return 0
        prompt_np = prompt_host(prompt_np)
        bs = self.cache.block_size
        S = int(prompt_np.shape[0])
        keys = chain_keys(prompt_np, bs, (S - 1) // bs,
                          salt=self._adapter_salt(adapter))
        staged: List[bytes] = []
        todo = []
        for key in keys[:(S - 1) // bs]:
            if key in self.cache.index:
                if staged:
                    break
                continue
            data = tier.get(key)
            if data is None:
                break
            if key not in tier.staged:
                todo.append((key, data))
            staged.append(key)
        if todo:
            self._stage_uploads(tier, todo)
        tier.clear_staged(keep=staged)
        return len(staged)

    def _adapter_salt(self, adapter: int) -> bytes:
        """The prefix chain's salt: the adapter id with a bank, else
        none (the reference's ``b"adapter:%d"``)."""
        return b"adapter:%d" % adapter if self._ml.enabled else b""

    def _stage_uploads(self, tier, todo) -> None:
        """One upload of the tier blocks in ``todo`` into a staging
        tensor on the card, on the side stream, closed by one event that
        the consuming admission waits on."""
        arena = host_arena(self.cache)
        rows_src = [d.row if getattr(d, "row", None) is not None else None
                    for _, d in todo]
        slots = [d.slot for _, d in todo
                 if getattr(d, "slot", None) is not None]
        event, stream = None, None
        if arena.cuda:
            if self._h2d_stream is None:
                self._h2d_stream = torch.cuda.Stream(self.device)
            stream = self._h2d_stream
        with (torch.cuda.stream(stream) if stream is not None
              else contextlib.nullcontext()):
            if stream is not None:
                arena.wait_on_stream(slots, stream)
            rows = torch.empty((len(todo), arena.slot_bytes),
                               dtype=torch.uint8, device=self.device)
            views = arena.leaves(rows)
            for i, (_, d) in enumerate(todo):
                if rows_src[i] is not None:
                    rows[i].copy_(rows_src[i], non_blocking=True)
                else:
                    for pf, v in views.items():
                        v[i].copy_(d[pf], non_blocking=True)
            if stream is not None:
                event = torch.cuda.Event()
                event.record(stream)
        arena.fence(slots, event)
        for i, (key, _) in enumerate(todo):
            tier.stage(key, Payload(arena.leaves(rows[i]), row=rows[i],
                                    event=event))

    def _grow_active(self, extra: int = 0) -> None:
        """Allocate the blocks active slots need through position
        length + ``extra`` (a speculative round writes h tokens ahead;
        clamped at slot capacity, past which writes go to the trash
        block): host-mirror reads only, one device write for the
        batch."""
        bs = self.cache.block_size
        mb = self.cache.max_blocks
        lengths = self.cache.host_lengths()
        table = self.cache.host_table()
        slots, bis = [], []
        for slot in np.nonzero(self.active)[0]:
            lo = int(lengths[slot]) // bs
            if lo >= mb:
                raise SlotCapacityExceeded(
                    int(slot), f"slot {slot} exceeded max_blocks")
            hi = min((int(lengths[slot]) + extra) // bs, mb - 1)
            for bi in range(lo, hi + 1):
                if table[slot, bi] < 0:
                    slots.append(int(slot))
                    bis.append(bi)
        # Check-then-pop: a shortfall raises with the free list intact.
        ids = alloc_blocks(self.cache, len(slots))
        for b in ids:
            self.cache.refs[b] = 1
        if self.kv_quota is not None:
            # Growth is charged, never refused (a refusal would poison a
            # whole batched tick); over-ceiling growth marks the tenant
            # and the engine aims its next preemption there.
            for slot in slots:
                t = self._slot_tenant.get(slot, "default")
                self.kv_quota.charge(t, 1)
                self._slot_charge[slot] = self._slot_charge.get(slot, 0) + 1
        if slots:
            table[slots, bis] = ids
            dev = self.device
            self.cache.block_table[
                torch.as_tensor(slots, device=dev),
                torch.as_tensor(bis, device=dev)] = torch.as_tensor(
                    ids, dtype=torch.int32, device=dev)

    def step(self, prefill_work: Optional[int] = None,
             max_chunk_tokens: Optional[int] = None) -> Dict[int, Any]:
        """One greedy decode step for every active slot; returns
        {slot: new_token}. Speculative servers return {slot: [tokens]}
        (up to gamma x horizon + 1 per slot). Slots at capacity
        deactivate (their blocks stay readable until evict).

        ``prefill_work``: a slot with an in-flight chunked admission —
        its next chunk (capped at ``max_chunk_tokens``, rounded down to
        blocks) rides the same multi-token paged forward as the decode
        rows. A tick carrying a fused chunk is always a plain tick (on a
        speculative server the draft mirrors the decode tokens and the
        chunk in one draft forward). On the completing chunk the dict
        also carries the admitted slot's first token."""
        return self.step_async(prefill_work, max_chunk_tokens).finalize()

    def step_async(self, prefill_work: Optional[int] = None,
                   max_chunk_tokens: Optional[int] = None) -> PendingStep:
        """step() with the token fetch deferred: block growth, the
        forwards, pool/length updates and capacity retirement happen
        here; finalize() does the ONE device-to-host fetch."""
        if prefill_work is not None:
            if prefill_work not in self._admissions:
                raise ValueError(f"slot {prefill_work} has no in-flight "
                                 f"admission")
            return self._fused_tick_async(prefill_work, max_chunk_tokens)
        if self.speculative:
            return self._spec_step_async()
        if not self.active.any():
            return PendingStep.done({})
        self._grow_active()
        c = self.cache
        logits, _, _, c.lengths = decode_core(
            self.params, self.last_token, c.pool_k, c.pool_v,
            c.block_table, c.lengths, self._active_dev, **self._pool_kw(),
            **self._ml.kw())
        nxt = self._sampler.pick(logits[:, 0])
        self.last_token = torch.where(self._active_dev[:, None],
                                      nxt[:, None], self.last_token)
        # The host mirror advances by the same +1 per active slot.
        lnp = c.host_lengths()
        lnp[self.active] += 1
        slots = [int(s) for s in np.nonzero(self.active)[0]]
        hit_cap = False
        for slot in slots:
            if int(lnp[slot]) >= self.slot_capacity:
                self.active[slot] = False
                hit_cap = True
        if hit_cap:
            self._sync_active()

        def _finalize(invalid):
            self.device_fetches += 1
            toks = nxt.tolist()  # tpushare: ignore[TS103] the one token fetch
            return {s: toks[s] for s in slots if s not in invalid}

        return PendingStep(_finalize, slots=slots)

    def _fused_tick_async(self, slot: int,
                          max_chunk_tokens: Optional[int]) -> PendingStep:
        """One fused tick over the pool: every active decode slot
        contributes its pending token and admission ``slot`` its next
        (block-aligned) chunk, in ONE multi-token paged forward. The
        chunk attends its already-written prefix straight off the pool
        and its KV lands in the slot's reserved blocks; decode rows'
        junk columns write KV past their lengths that the length mask
        keeps unattended. One device-to-host fetch (a completing
        admission's first token rides it)."""
        st = self._admissions[slot]
        if not self.active.any():
            # No decode batch to fuse into: serial admission, still
            # capped by the tick budget.
            tok = self.admit_step(slot, max_chunk_tokens=max_chunk_tokens)
            return PendingStep.done({} if tok is None else {slot: tok})
        S = int(st["prompt_np"].shape[0])
        done = st["done"]
        end, width = fused_chunk_span(done, S, st["chunk"],
                                      max_chunk_tokens,
                                      gran=self.cache.block_size)
        if width == 0:
            return self.step_async()    # budget left no chunk room
        self._grow_active()
        c = self.cache
        toks = fused_token_batch(self.last_token, st["prompt"], done, end,
                                 width, slot)
        pos = c.lengths.clone()
        pos[slot] = done
        # The admitting slot must write (its table row is reserved);
        # decode rows write their one real token; the rest go to trash.
        wmask = self._active_dev.clone()
        wmask[slot] = True
        mkw = self._ml.kw()
        logits = verify_core(self.params, toks, c.pool_k, c.pool_v,
                             c.block_table, pos, wmask, **self._pool_kw(),
                             **mkw)
        c.lengths = c.lengths + self._active_dev.to(c.lengths.dtype)
        if self.speculative:
            # One draft forward: decode rows mirror their pending
            # token's draft KV, the admitting row advances its draft
            # chunk — same batch, logits dropped.
            verify_core(self.draft_params, toks, self._dpk, self._dpv,
                        c.block_table, pos, wmask, **self._draft_kw(),
                        **mkw)
        st["done"] = end
        st["row_stale"] = True
        final = end >= S
        if final:
            # Admission pick before the decode pick, as the reference.
            first = self._sampler.pick(logits[slot:slot + 1, S - 1 - done])
        nxt = self._sampler.pick(logits[:, 0])
        self.last_token = torch.where(self._active_dev[:, None],
                                      nxt[:, None], self.last_token)
        lnp = c.host_lengths()
        lnp[self.active] += 1
        decode_slots = [int(s) for s in np.nonzero(self.active)[0]]
        for s in decode_slots:
            if int(lnp[s]) >= self.slot_capacity:
                self.active[s] = False
        fetch = nxt
        if final:
            del self._admissions[slot]
            if self.prefix_cache:
                publish_prefix(c, st["blocks"], st["prompt_np"],
                               keys=st["keys"])
            self.last_token[slot, 0] = first[0]
            self.active[slot] = True
            fetch = torch.cat([nxt, first])        # one transfer
        self._sync_active()
        out_slots = decode_slots + ([slot] if final else [])

        def _finalize(invalid):
            self.device_fetches += 1
            toks_h = fetch.tolist()  # tpushare: ignore[TS103] the one token fetch
            out: Dict[int, int] = {s: toks_h[s] for s in decode_slots
                                   if s not in invalid}
            if final and slot not in invalid:
                out[slot] = toks_h[-1]
            return out

        return PendingStep(_finalize, slots=out_slots)

    # -- speculation hooks (models/spec.py SpecDecodeMixin owns the
    # round loop; these supply the paged mechanics) -----------------

    def _spec_begin(self, h: int) -> torch.Tensor:
        """Blocks through position length + h (the round's last write),
        clamped at capacity."""
        self._grow_active(extra=h)
        return self.cache.lengths

    def _spec_draft_step(self, tok, base, j: int) -> torch.Tensor:
        """One draft decode over the draft pools at position base + j."""
        dl, _, _, _ = decode_core(
            self.draft_params, tok, self._dpk, self._dpv,
            self.cache.block_table, base + j, self._active_dev,
            **self._draft_kw(), **self._ml.kw())
        return dl[:, 0]

    def _spec_draft_catchup(self, block, tok, base, h: int) -> None:
        """The extra draft step that writes the last proposal's draft KV
        at base + h (output discarded)."""
        del block
        decode_core(self.draft_params, tok, self._dpk, self._dpv,
                    self.cache.block_table, base + h, self._active_dev,
                    **self._draft_kw(), **self._ml.kw())

    def _spec_verify(self, block, base) -> torch.Tensor:
        """ONE multi-token target verify over the pools."""
        c = self.cache
        return verify_core(self.params, block, c.pool_k, c.pool_v,
                           c.block_table, base, self._active_dev,
                           **self._pool_kw(), **self._ml.kw())

    def _spec_commit(self, a_b, correction, active) -> None:
        c = self.cache
        c.lengths = c.lengths + ((a_b + 1) * active).to(c.lengths.dtype)
        self.last_token = torch.where(active[:, None], correction,
                                      self.last_token)

    def _spec_host_lengths(self) -> np.ndarray:
        return self.cache.host_lengths()

    def _spec_capacity(self) -> int:
        return self.slot_capacity

    @property
    def admitting_count(self) -> int:
        """Chunked admissions in flight."""
        return len(self._admissions)

    @property
    def admission_slots(self):
        """Slots with an in-flight chunked admission (the engine evicts
        any it is not tracking after a mid-admission fault)."""
        return list(self._admissions)

    def _refund_slot(self, slot: int) -> None:
        """Return the slot's whole KV-quota charge to its tenant: the one
        refund point, paired with the admission and growth charges."""
        charged = self._slot_charge.pop(slot, 0)
        tenant = self._slot_tenant.pop(slot, None)
        if self.kv_quota is not None and tenant is not None:
            self.kv_quota.refund(tenant, charged)

    def slot_tenants(self) -> Dict[int, str]:
        """Live slot -> tenant view (the engine's preemption targeting)."""
        return dict(self._slot_tenant)

    def evict(self, slot: int) -> None:
        """Free the slot's blocks back to the pool (refcounted and
        LRU-retained when published) and refund its quota charge. Safe
        mid-admission."""
        self.active[slot] = False
        self._sync_active()
        self._admissions.pop(slot, None)
        self._ml.reset(slot)
        self._refund_slot(slot)
        self.cache = release(self.cache, slot)
