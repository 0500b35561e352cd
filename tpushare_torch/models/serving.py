"""Serving pieces the slot servers share, and the dense-row slot server.
Counterpart of ``tpushare/models/serving.py``: ``TokenSampler`` (with
the NaN -> -1 guard), ``PendingStep``, the fused admission tick's
``bucket_len`` / ``fused_chunk_span`` / ``fused_token_batch``, the
multi-LoRA slot bookkeeping (``validate_adapter``, ``MultiLoraSlots``),
and ``SlotServer`` (continuous batching over one static row cache).

Sharded serving over a ``parallel.mesh.ServingMesh`` (reference
``serving.py:77-340``): ``MeshPlacement`` is the one home of the
placement contract — weights per the family's spec tree (the Megatron
split of the dense model, experts over ep and their hidden axis over tp
for MoE), KV rows and pools split on the kv-head axis over tp, control
state (block tables, lengths, tokens, ``active``) replicated. Each rank
is a process holding its own contiguous slices; it runs the same slot
server code on the same calls, so every host decision (admission,
eviction, prefix chains, block ids) is identical on every rank by
construction, and the logits come out of the forward replicated (the
tp / ep sums are all-reduces written out over ``torch.distributed``).
Every rank samples the same token from the same seeded generator and
makes one fetch per tick. On a mesh a server's ``cfg`` is its rank's
geometry (heads and the FFN hidden axis divided by tp) and
``model_cfg`` the whole model's. ``make_tp_decoder``,
``make_moe_decoder``, ``make_tp_paged_decoder`` and ``sharded_cache``
are the decoder factories over the same contract."""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.generate import sample_logits


def bucket_len(n: int, floor: int = 16) -> int:
    """Next power of two >= n (floor 16): the one bucketing policy the
    slot servers share."""
    b = floor
    while b < n:
        b *= 2
    return b


def fused_chunk_span(done: int, S: int, chunk: int,
                     max_chunk_tokens: Optional[int] = None,
                     gran: int = 1) -> Tuple[int, int]:
    """This tick's fused-admission span [done, end) and the padded
    batch width. Mid chunks run at the fixed ``chunk`` width; the final
    chunk bucket-pads, capped at ``chunk``. ``max_chunk_tokens`` is the
    engine's per-tick token budget for the chunk, rounded down to
    ``gran`` (the pool's block size). Returns (end, width); width == 0
    means the budget leaves no room for one granule and the caller runs
    a plain tick."""
    eff = chunk
    if max_chunk_tokens is not None:
        eff = min(eff, (max_chunk_tokens // gran) * gran)
    if eff < max(1, gran):
        return done, 0
    end = min(S, done + eff)
    width = min(bucket_len(end - done), eff) if end >= S else eff
    return end, width


def fused_token_batch(last_token: torch.Tensor, prompt: torch.Tensor,
                      done: int, end: int, width: int,
                      slot: int) -> torch.Tensor:
    """The fused tick's [B, width] token batch: every row's column 0 is
    its pending last token (decode rows consume exactly that; their
    columns >= 1 are junk whose KV the length masks keep unattended
    until real writes overwrite it), and the admitting row carries
    prompt[done:end] zero-padded to ``width``."""
    B = last_token.shape[0]
    toks = torch.zeros((B, width), dtype=torch.int64,
                       device=last_token.device)
    toks[:, 0] = last_token[:, 0]
    toks[slot] = 0
    toks[slot, :end - done] = prompt[done:end].to(torch.int64)
    return toks


def validate_adapter(adapter, enabled: bool, bank_size: int) -> None:
    """Host-side multi-LoRA index check both slot servers share: an
    out-of-range index would gather another tenant's adapter (or fail
    inside a batched tick), so it fails here instead. Bools are refused
    too (bool subclasses int: {"adapter": true} from JSON would select
    adapter 1)."""
    if isinstance(adapter, bool) or not isinstance(adapter, int):
        raise ValueError(f"adapter must be an int, got {adapter!r}")
    if adapter != -1 and not (enabled and 0 <= adapter < bank_size):
        raise ValueError(
            f"adapter {adapter} out of range for a bank of "
            f"{bank_size} (multi_lora "
            f"{'set' if enabled else 'not set'}) — a clamped device "
            f"gather would silently serve another tenant's adapter")


class MultiLoraSlots:
    """Per-slot adapter bookkeeping both slot servers share: the bank
    size, the host-truth adapter of each slot and its device mirror, and
    the forward kwargs that apply them (``kw()``: the batch's
    ``mlora_idx`` [n_slots]; ``kw(adapter)``: one admission row's).
    Disabled (no bank), ``kw`` is empty and only adapter -1 passes."""

    def __init__(self, multi_lora, n_slots: int, scale: float = 1.0,
                 device: DeviceLike = "cpu"):
        from tpushare_torch.models.lora import bank_size
        self.enabled = multi_lora is not None
        self.bank_size = bank_size(multi_lora) if self.enabled else 0
        self.scale = scale
        self.device = torch.device(device)
        self._host = np.full(n_slots, -1, np.int64)
        self.dev = torch.full((n_slots,), -1, dtype=torch.int64,
                              device=self.device)

    def validate(self, adapter) -> None:
        validate_adapter(adapter, self.enabled, self.bank_size)

    def set(self, slot: int, adapter: int) -> None:
        """Host truth, then the mirror (an upload, always a copy)."""
        if not self.enabled:
            return
        self._host[slot] = adapter
        self.dev = torch.tensor(self._host, device=self.device)

    def reset(self, slot: int) -> None:
        self.set(slot, -1)

    def kw(self, adapter: Optional[int] = None) -> Dict[str, Any]:
        if not self.enabled:
            return {}
        idx = (self.dev if adapter is None else
               torch.tensor([adapter], dtype=torch.int64,
                            device=self.device))
        return {"mlora_idx": idx, "mlora_scale": self.scale}


class TokenSampler:
    """Per-server sampling state: the sampling config plus ONE explicit
    ``torch.Generator`` on the server's device, seeded from ``seed``, so
    slot streams are reproducible for a given (seed, admission order).
    It replaces the reference's (seed, draw-counter) key stream; the
    speculative cores draw from the same ``generator``."""

    def __init__(self, temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, device: DeviceLike = "cpu"):
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed
        self.generator = torch.Generator(device=torch.device(device))
        self.generator.manual_seed(seed)

    def pick(self, logits: torch.Tensor) -> torch.Tensor:
        """[B, V] logits -> [B] token ids on the logits' device, greedy
        when temperature == 0. A NaN logits row picks -1 (invalid by
        construction): bare argmax or a draw would launder a poisoned
        row into a plausible in-vocab id."""
        tok = sample_logits(logits, self.generator,
                            temperature=self.temperature, top_k=self.top_k,
                            top_p=self.top_p)
        bad = torch.isnan(logits).any(dim=-1)
        return torch.where(bad, torch.full_like(tok, -1), tok)


def cache_specs() -> Dict[str, Any]:
    """Dense KV rows [L, B, S, Hkv, Dh]: kv heads over tp."""
    from tpushare_torch.parallel.sharding import P
    spec = P(None, None, None, "tp", None)
    return {"k": spec, "v": spec}


def paged_pool_specs():
    """Paged KV pool [L, n_blocks, bs, Hkv, Dh]: kv heads over tp (the
    rows' head split; the block axis is never split, so block ids stay
    host-global)."""
    from tpushare_torch.parallel.sharding import P
    return P(None, None, None, "tp", None)


def mesh_axes(mesh) -> Optional[Dict[str, int]]:
    """Mesh axis sizes with 1-sized axes elided — the spelling /stats
    reports ({} = a one-rank mesh, None = no mesh)."""
    if mesh is None:
        return None
    return {ax: int(s) for ax, s in mesh.shape.items() if s > 1}


def default_param_specs(cfg):
    """The family's full-precision spec tree, off the config's shape
    (an MoEConfig carries n_experts). Int8 trees pass
    ``quant.quant_param_specs`` / ``quant_moe_param_specs``."""
    if hasattr(cfg, "n_experts"):
        from tpushare_torch.models import moe as _moe
        return _moe.param_specs(cfg)
    from tpushare_torch.models.transformer import param_specs
    return param_specs(cfg)


def make_placement(mesh, cfg, param_specs=None, *, role: str = "target"):
    """Build and check a MeshPlacement (None mesh -> None): the one
    constructor every slot-server family and its draft side call."""
    if mesh is None:
        return None
    place = MeshPlacement(mesh, param_specs or default_param_specs(cfg))
    place.check(cfg, role=role)
    return place


class MeshPlacement:
    """The sharded slot servers' placement contract (reference
    ``MeshPlacement``): ``place_params`` cuts a whole tree into this
    rank's contiguous slices per the spec tree; KV storage (rows and
    pools) holds this rank's kv heads (``local_cfg``); control state
    stays replicated. ``forward_fn`` binds a forward to the mesh's tp
    (and ep) groups, run without grad."""

    def __init__(self, mesh, param_specs_tree):
        from tpushare_torch.parallel.mesh import ServingMesh
        if not isinstance(mesh, ServingMesh):
            raise TypeError(f"mesh must be a parallel.mesh.ServingMesh "
                            f"(serving_mesh(...).bind(...)), got "
                            f"{type(mesh).__name__}")
        self.mesh = mesh
        self._pspecs = param_specs_tree
        self.kv = paged_pool_specs()

    @property
    def shape(self) -> Dict[str, int]:
        """Mesh axis sizes, 1-sized axes elided (the /stats spelling)."""
        return mesh_axes(self.mesh)

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    def check(self, cfg, *, role: str = "target") -> None:
        """Fail loudly before any placement (the reference's messages):
        a non-dividing axis would cut a head or an expert."""
        tp = self.mesh.shape.get("tp", 1)
        ep = self.mesh.shape.get("ep", 1)
        if cfg.n_kv_heads % tp:
            raise ValueError(f"tp={tp} must divide the {role} model's "
                             f"n_kv_heads={cfg.n_kv_heads}")
        n_experts = getattr(cfg, "n_experts", None)
        if n_experts is None:
            if ep > 1:
                raise ValueError(
                    f"ep={ep} is an expert-parallel axis; the {role} "
                    f"model is dense (use tp, or serve an MoE family)")
        elif n_experts % ep:
            raise ValueError(f"ep={ep} must divide the {role} model's "
                             f"n_experts={n_experts}")
        unused = [ax for ax, s in self.mesh.shape.items()
                  if s > 1 and ax not in ("tp", "ep")]
        if unused:
            raise ValueError(
                f"serving shards over tp/ep only; axes {unused} would "
                f"silently replicate every weight and pool shard")
        if self.mesh.size > 1 and self.mesh.rank is None:
            raise ValueError("the mesh is not bound to a process group "
                             "(ServingMesh.bind)")

    def place_params(self, params):
        from tpushare_torch.parallel.sharding import shard_tree
        return shard_tree(params, self._pspecs, self.mesh)

    def place_kv(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's kv heads of a whole KV leaf (rows or pool)."""
        from tpushare_torch.parallel.sharding import shard_leaf
        return shard_leaf(t, self.kv, self.mesh.sizes,
                          self.mesh.coords(self.mesh.rank or 0),
                          self.mesh.device)

    def local_cfg(self, cfg):
        """``cfg`` at this rank's geometry: heads and the FFN hidden
        axis divided by tp (experts stay global: routing spans them)."""
        tp = self.mesh.shape.get("tp", 1)
        if tp == 1:
            return cfg
        return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp,
                                   n_kv_heads=cfg.n_kv_heads // tp,
                                   d_ff=cfg.d_ff // tp)

    def forward_fn(self, base):
        """``base`` (a ``transformer.forward``-shaped callable) bound to
        the mesh's groups — ``pctx.tp``, and ``ep_axis`` where the
        mesh has ep — and run without grad (a server keeps no autograd
        graph; the no-grad path sums each partial in place)."""
        from tpushare_torch.models.transformer import ParallelCtx
        kw = {"pctx": ParallelCtx(tp=self.mesh.axis_group("tp"))}
        if self.mesh.shape.get("ep", 1) > 1:
            kw["ep_axis"] = self.mesh.axis_group("ep")

        @functools.wraps(base)
        def fwd(*a, **k):
            with torch.no_grad():
                return base(*a, **kw, **k)
        return fwd


def _decoder_groups(cfg, mesh, family: str):
    place = MeshPlacement(mesh, default_param_specs(cfg))
    if family == "moe" and not hasattr(cfg, "n_experts"):
        raise ValueError("make_moe_decoder needs an MoE config")
    place.check(cfg)
    return place


def make_tp_decoder(cfg, mesh, *, quantized: bool = False):
    """(prefill_fn, decode_fn) over ``mesh``'s tp axis (reference
    ``:77-116``): prefill_fn(params, tokens, cache) and
    decode_fn(params, token, cache, offset) -> (logits, cache), offset
    an int or a [B] tensor (ragged rows). Params are this rank's slices
    per ``param_specs(cfg)`` (``quant.quant_param_specs`` with
    ``quantized``, each rank widening its own int8 slices per layer);
    caches from ``sharded_cache``."""
    from tpushare_torch.models.transformer import forward
    return _decoder_fns(forward, _decoder_groups(cfg, mesh, "dense"), cfg,
                        quantized, "dense")


def make_moe_decoder(cfg, mesh, *, quantized: bool = False):
    """The MoE LM's (prefill_fn, decode_fn) over ``mesh``'s ep x tp axes
    (reference ``:130-192``), the ``make_tp_decoder`` contract with the
    experts over ep; ``quantized`` trees widen per layer
    (``dequant_hook``)."""
    from tpushare_torch.models.moe import paged_forward
    return _decoder_fns(paged_forward, _decoder_groups(cfg, mesh, "moe"),
                        cfg, quantized, "moe")


def _decoder_fns(base, place, cfg, quantized: bool, family: str):
    from tpushare_torch.models.quant import dequant_hook
    fwd = place.forward_fn(base)
    hook = dequant_hook(cfg) if quantized else None
    lcfg = place.local_cfg(cfg)

    def prefill_fn(params, tokens, cache):
        return fwd(params, tokens, lcfg, cache=cache, pos_offset=0,
                   layers_hook=hook)

    def decode_fn(params, token, cache, offset):
        return fwd(params, token, lcfg, cache=cache, pos_offset=offset,
                   layers_hook=hook)

    return prefill_fn, decode_fn


def sharded_cache(cfg, mesh, batch: int, max_len: int):
    """This rank's dense KV rows (its kv heads) on its card; the MoE
    cache has the same layout, so one helper serves both families."""
    from tpushare_torch.models.transformer import init_cache
    tp = mesh.shape.get("tp", 1)
    return init_cache(cfg, batch, max_len, n_kv_heads=cfg.n_kv_heads // tp,
                      device=mesh.device)


def make_tp_paged_decoder(cfg, mesh, *, block_size: int,
                          attn_impl: str = "auto",
                          quantized: bool = False):
    """Tensor-parallel paged decode over ``mesh`` (reference
    ``:201-245``): decode_fn(params, tokens, pool_k, pool_v, table,
    lengths, active) -> (logits, pool_k, pool_v, lengths), the pools
    this rank's kv heads (``paged_pool_specs``), table / lengths /
    active replicated."""
    del block_size                  # the pools carry it
    from tpushare_torch.models.paged import decode_core
    from tpushare_torch.models.quant import dequant_hook
    from tpushare_torch.models.transformer import forward
    place = _decoder_groups(cfg, mesh, "dense")
    fwd = place.forward_fn(forward)
    hook = dequant_hook(cfg) if quantized else None
    lcfg = place.local_cfg(cfg)

    def decode_fn(params, tokens, pool_k, pool_v, table, lengths, active):
        logits, pk, pv, new_len = decode_core(
            params, tokens, pool_k, pool_v, table, lengths, active,
            cfg=lcfg, attn_impl=attn_impl, layers_hook=hook,
            forward_fn=fwd)
        return logits, pk, pv, new_len

    return decode_fn


class PendingStep:
    """A dispatched tick whose one device->host token fetch is still
    owed: ``step_async`` has enqueued all device work, ``finalize()``
    does the fetch and builds ``{slot: token}``.
    ``step() == step_async().finalize()``. ``finalize(invalid=...)``
    drops slots whose request changed while the tick was in flight.
    Finalize is one-shot."""

    __slots__ = ("_fn", "_ready", "slots")

    def __init__(self, finalize_fn=None, *, ready=None,
                 slots: Tuple[int, ...] = ()):
        self._fn = finalize_fn
        self._ready = ready
        self.slots = tuple(slots)

    @classmethod
    def done(cls, out: Dict[int, Any]) -> "PendingStep":
        """An already-finalized tick (e.g. an empty batch)."""
        return cls(ready=out, slots=tuple(out))

    def finalize(self, invalid=frozenset()) -> Dict[int, Any]:
        if self._fn is None:
            out = self._ready
            if invalid:
                out = {s: t for s, t in out.items() if s not in invalid}
            return out
        fn, self._fn = self._fn, None
        return fn(frozenset(invalid))


def prompt_host(prompt) -> np.ndarray:
    """A prompt (numpy, list or tensor) as an int64 host array."""
    if isinstance(prompt, torch.Tensor):
        return prompt.detach().cpu().numpy().astype(np.int64)
    return np.asarray(prompt, dtype=np.int64)


def prompt_tensor(prompt, device: torch.device) -> torch.Tensor:
    """A prompt (numpy, list or tensor) as an int64 tensor on ``device``."""
    if isinstance(prompt, torch.Tensor):
        return prompt.to(device=device, dtype=torch.int64)
    return torch.as_tensor(prompt_host(prompt), device=device)


def pad_tokens(prompt: torch.Tensor, done: int, end: int,
               width: int) -> torch.Tensor:
    """[1, width] tokens: prompt[done:end] zero-padded."""
    toks = torch.zeros((1, width), dtype=torch.int64, device=prompt.device)
    toks[0, :end - done] = prompt[done:end]
    return toks


class SlotServer:
    """Continuous batching over a fixed slot array: one static row cache
    ``[L, n_slots, max_len, ...]``; sequences at different lengths
    decode together through ``forward``'s dense ragged branches (per-row
    offsets; the S = 1 tick attends through ``flash_decode``). admit()
    prefills a free slot, step() advances every active slot one token,
    evict() frees a slot.

    Host/device split as in the reference: the host owns the active
    bitmap and an exact mirror of the lengths, so every tick makes ONE
    device-to-host transfer, the token fetch in ``PendingStep.finalize``.
    Ported: sampling (greedy, temperature, top-k, top-p), whole
    admission (bucket-padded, or in ``prefill_chunk`` pieces), chunked
    admission (``admit_start`` / ``admit_step``), the fused tick
    (``step(prefill_work=slot)``), ``kv_quant`` (int8 rows),
    ``layers_hook`` (int8 weights) and ``multi_lora`` (an adapter bank
    from ``lora.stack_adapters``: each slot picks its adapter at
    ``admit(prompt, adapter=i)``, -1 the base model, and every row
    applies its own delta inside one batched forward). ``mesh`` (a bound
    ``ServingMesh``): weights per ``param_specs`` (default the family's
    full-precision tree), rows of this rank's kv heads, the forward
    bound to the mesh's groups (``MeshPlacement``); not with kv_quant
    or multi_lora, as in the reference. Rows are updated in place (the
    reference rebinds new arrays)."""

    def __init__(self, params, cfg, *, n_slots: int, max_len: int,
                 attn_impl: str = "auto", layers_hook=None,
                 temperature: float = 0.0, top_k=None, top_p=None,
                 seed: int = 0, prefill_chunk: int = 0,
                 kv_quant: bool = False, multi_lora=None,
                 mlora_scale: float = 1.0, mesh=None, param_specs=None,
                 device: DeviceLike = None):
        self.mesh = mesh
        self.model_cfg = cfg
        if mesh is not None and (kv_quant or multi_lora is not None):
            raise ValueError(
                "mesh sharding does not compose with kv_quant/"
                "multi_lora yet (the int8 scale pools' padded-head "
                "layout and the adapter bank have no sharded "
                "placement contract — documented seams)")
        self._placement = make_placement(mesh, cfg, param_specs)
        if self._placement is not None:
            params = self._placement.place_params(params)
            cfg = self._placement.local_cfg(cfg)
            device = self._placement.device
        self.device = resolve_device(device)
        if multi_lora is not None:
            from tpushare_torch.models.lora import multi_lora_params
            params = multi_lora_params(params, multi_lora)
        self._ml = MultiLoraSlots(multi_lora, n_slots, mlora_scale,
                                  self.device)
        self.params = params
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_len = max_len
        self.attn_impl = attn_impl
        self.layers_hook = layers_hook
        self._forward, self._init_cache = self._family(kv_quant)
        if self._placement is not None:
            self._forward = self._placement.forward_fn(self._forward)
        self.cache = self._new_rows(n_slots)
        self.device_fetches = 0
        self.lengths = torch.zeros((n_slots,), dtype=torch.int32,
                                   device=self.device)
        self._lengths_np = np.zeros((n_slots,), np.int64)     # host mirror
        self.last_token = torch.zeros((n_slots, 1), dtype=torch.int64,
                                      device=self.device)
        self.active = np.zeros(n_slots, dtype=bool)            # host truth
        self._active_dev = torch.zeros((n_slots,), dtype=torch.bool,
                                       device=self.device)
        self._admissions: Dict[int, Dict[str, Any]] = {}
        self._sampler = TokenSampler(temperature, top_k, top_p, seed,
                                     device=self.device)
        self._prefill_chunk = prefill_chunk

    def _family(self, kv_quant: bool):
        """(forward, init_cache) of the model family served: the dense
        LM's (int8 rows under ``kv_quant``). ``moe.MoESlotServer``
        serves the MoE LM through the same server by overriding this
        and the prefix hooks."""
        from tpushare_torch.models import quant, transformer
        return transformer.forward, (quant.init_cache_q8 if kv_quant
                                     else transformer.init_cache)

    def _admitted(self, slot: int, st: Dict[str, Any], row) -> None:
        """A chunked admission completed (``row``: its private row, or
        None once it lives in the shared cache); the MoE server retains
        its prefix here."""

    def _slot_row(self, slot: int) -> Dict[str, torch.Tensor]:
        """The slot's row of the shared cache (a view: writes land in
        the cache)."""
        return {kk: v[:, slot:slot + 1] for kk, v in self.cache.items()}

    def _new_rows(self, n: int) -> Dict[str, torch.Tensor]:
        return self._init_cache(self.cfg, n, self.max_len,
                                device=self.device)

    def _fwd(self, tokens, **kw):
        return self._forward(self.params, tokens, self.cfg,
                             attn_impl=self.attn_impl,
                             layers_hook=self.layers_hook, **kw)

    def _sync_active(self) -> None:
        """Host bitmap -> device mirror (an upload; always a copy)."""
        self._active_dev = torch.tensor(self.active, device=self.device)

    def _install(self, slot: int, row: Dict[str, torch.Tensor]) -> None:
        for kk in self.cache:
            self.cache[kk][:, slot] = row[kk][:, 0]

    def _set_length(self, slot: int, n: int) -> None:
        self.lengths[slot] = n
        self._lengths_np[slot] = n

    def _activate(self, slot: int, first: torch.Tensor, S: int) -> None:
        self._set_length(slot, S)
        self.last_token[slot, 0] = first
        self.active[slot] = True
        self._sync_active()

    def _claim_slot(self, prompt: torch.Tensor) -> int:
        """Shared admit validation + slot pick (mid-chunked-admission
        slots have active=False but are NOT free)."""
        from tpushare_torch.models.paged import PoolExhausted
        if prompt.ndim != 1:
            raise ValueError("admit takes a single unbatched prompt")
        S = int(prompt.shape[0])
        if S >= self.max_len:
            raise ValueError(f"prompt length {S} >= max_len {self.max_len}")
        for slot in range(self.n_slots):
            if not self.active[slot] and slot not in self._admissions:
                return slot
        raise PoolExhausted("no free slots")

    @property
    def admitting_count(self) -> int:
        return len(self._admissions)

    @property
    def admission_slots(self):
        return list(self._admissions)

    def admit(self, prompt, adapter: int = -1) -> int:
        """Prefill ``prompt`` [S] into a free slot; returns the slot.
        The prompt zero-pads to its power-of-two bucket (or to a
        multiple of ``prefill_chunk``, prefilled piece by piece); rows
        past S are junk the length mask never attends. ``adapter``: the
        slot's multi-LoRA bank index (-1 = base model)."""
        from tpushare_torch.models.transformer import chunked_prefill_loop
        self._ml.validate(adapter)
        prompt = prompt_tensor(prompt, self.device)
        slot = self._claim_slot(prompt)
        self._ml.set(slot, adapter)
        mkw = self._ml.kw(adapter)
        S = int(prompt.shape[0])
        row = self._new_rows(1)
        chunk = self._prefill_chunk
        if chunk and S > chunk:
            n_pad = min(-(-S // chunk) * chunk, self.max_len)
            last, row = chunked_prefill_loop(
                lambda p, t, **kw: self._fwd(t, **kw, **mkw), self.params,
                pad_tokens(prompt, 0, S, n_pad), row, chunk, S - 1)
            last = last[0]
        else:
            logits, row = self._fwd(
                pad_tokens(prompt, 0, S, min(bucket_len(S), self.max_len)),
                cache=row, pos_offset=0, **mkw)
            last = logits[0, S - 1]
        self._install(slot, row)
        self._activate(slot, self._sampler.pick(last[None, :])[0], S)
        return slot

    def admit_start(self, prompt, adapter: int = -1,
                    chunk_tokens: Optional[int] = None) -> int:
        """Begin a chunked admission: reserve a slot, prefill nothing;
        drive with admit_step() (one chunk per call) or
        step(prefill_work=slot) (the fused tick)."""
        self._ml.validate(adapter)
        prompt = prompt_tensor(prompt, self.device)
        slot = self._claim_slot(prompt)
        chunk = int(chunk_tokens or self._prefill_chunk or prompt.shape[0])
        if chunk < 1:
            raise ValueError("chunk_tokens must be >= 1")
        self._ml.set(slot, adapter)
        self._admissions[slot] = {
            "prompt": prompt, "S": int(prompt.shape[0]), "done": 0,
            "chunk": chunk, "row": self._new_rows(1), "in_cache": False,
            "adapter": adapter}
        return slot

    def _chunk_span(self, S: int, done: int, chunk: int,
                    max_chunk_tokens: Optional[int] = None
                    ) -> Tuple[int, int]:
        """(end, width) of a serial chunk from ``done``: the chunk capped
        at ``max_chunk_tokens``; the final chunk zero-pads to a
        power-of-two bucket capped at the chunk, or runs at its exact
        width where the padded end would pass max_len."""
        if max_chunk_tokens is not None:
            chunk = max(1, min(chunk, max_chunk_tokens))
        end = min(S, done + chunk)
        width = end - done
        if end >= S:
            width = min(bucket_len(end - done), chunk)
            if done + width > self.max_len:
                width = end - done
        return end, width

    def _chunk_forward(self, st, row, max_chunk_tokens=None):
        """One serial prefill chunk [done, end) into ``row``. The final
        chunk zero-pads to a power-of-two bucket capped at the chunk,
        or runs at its exact width where the padded end would pass
        max_len. Returns (last-position logits [1, V] on the final
        chunk else None, end)."""
        S, done = st["S"], st["done"]
        end, width = self._chunk_span(S, done, st["chunk"],
                                      max_chunk_tokens)
        logits, _ = self._fwd(pad_tokens(st["prompt"], done, end, width),
                              cache=row, pos_offset=done,
                              **self._ml.kw(st.get("adapter", -1)))
        return (logits[:1, S - 1 - done] if end >= S else None), end

    def admit_step(self, slot: int,
                   max_chunk_tokens: Optional[int] = None) -> Optional[int]:
        """Prefill the next chunk of a started admission (capped at
        ``max_chunk_tokens``). Returns None while chunks remain; the
        final call installs the row, samples the first token (one
        fetch), activates the slot and returns that token. After fused
        chunks the admission lives in the shared cache and serial
        chunks write the slot's row there directly."""
        st = self._admissions.get(slot)
        if st is None:
            raise ValueError(f"slot {slot} has no in-flight admission "
                             f"(already completed, evicted, or admitted "
                             f"whole)")
        row = self._slot_row(slot) if st["in_cache"] else st["row"]
        last, end = self._chunk_forward(st, row, max_chunk_tokens)
        st["done"] = end
        if end < st["S"]:
            if st["in_cache"]:
                # Keep the in-cache admission's length at its write
                # frontier: a plain tick's junk write for this inactive
                # row lands where the next chunk overwrites it.
                self._set_length(slot, end)
            return None
        del self._admissions[slot]
        self._admitted(slot, st, None if st["in_cache"] else row)
        if not st["in_cache"]:
            self._install(slot, row)
        nxt = self._sampler.pick(last)[0]
        self._activate(slot, nxt, st["S"])
        self.device_fetches += 1
        return int(nxt.item())  # tpushare: ignore[TS103] the one token fetch

    def step(self, prefill_work: Optional[int] = None,
             max_chunk_tokens: Optional[int] = None) -> Dict[int, int]:
        """One greedy decode step for every active slot -> {slot: token};
        a slot reaching max_len retires. ``prefill_work``: a slot with
        an in-flight chunked admission whose next chunk rides the same
        forward as the decode rows (capped at ``max_chunk_tokens``);
        the completing chunk's first token comes back in the dict."""
        return self.step_async(prefill_work, max_chunk_tokens).finalize()

    def step_async(self, prefill_work: Optional[int] = None,
                   max_chunk_tokens: Optional[int] = None) -> PendingStep:
        """step() with the token fetch deferred to finalize()."""
        if prefill_work is not None:
            return self._fused_tick_async(prefill_work, max_chunk_tokens)
        if not self.active.any():
            return PendingStep.done({})
        logits, _ = self._fwd(self.last_token, cache=self.cache,
                              pos_offset=self.lengths, **self._ml.kw())
        nxt = self._sampler.pick(logits[:, 0])
        self._advance(nxt)
        slots = [int(s) for s in np.nonzero(self.active)[0]]
        self._lengths_np[self.active] += 1
        if self._retire(slots):
            self._sync_active()

        def _finalize(invalid):
            self.device_fetches += 1
            toks = nxt.tolist()  # tpushare: ignore[TS103] the one token fetch
            return {s: toks[s] for s in slots if s not in invalid}

        return PendingStep(_finalize, slots=slots)

    def _advance(self, nxt: torch.Tensor) -> None:
        """Device side of a tick: +1 length and the new last token for
        every active slot."""
        self.lengths = self.lengths + self._active_dev.to(torch.int32)
        self.last_token = torch.where(self._active_dev[:, None],
                                      nxt[:, None], self.last_token)

    def _retire(self, slots) -> bool:
        """Deactivate slots whose next write would pass max_len (host
        mirror only)."""
        hit = False
        for s in slots:
            if int(self._lengths_np[s]) >= self.max_len:
                self.active[s] = False
                hit = True
        return hit

    def _fused_tick_async(self, slot: int,
                          max_chunk_tokens: Optional[int]) -> PendingStep:
        """One fused tick: every active decode slot contributes 1 token
        and admission ``slot`` its next chunk, in ONE forward (the
        ragged multi-token dense branch). One device-to-host fetch; a
        completing admission's first token rides it."""
        st = self._admissions.get(slot)
        if st is None:
            raise ValueError(f"slot {slot} has no in-flight admission")
        if not self.active.any():
            tok = self.admit_step(slot, max_chunk_tokens=max_chunk_tokens)
            return PendingStep.done({} if tok is None else {slot: tok})
        done, S = st["done"], st["S"]
        end, width = fused_chunk_span(done, S, st["chunk"], max_chunk_tokens)
        if width == 0:
            return self.step_async()
        if not st["in_cache"]:
            # First fused chunk: the admission's [0, done) KV moves from
            # its serial row into the shared cache row.
            self._install(slot, st["row"])
            st["row"] = None
            st["in_cache"] = True
        toks = fused_token_batch(self.last_token, st["prompt"], done, end,
                                 width, slot)
        pos = self.lengths.clone()
        pos[slot] = done
        logits, _ = self._fwd(toks, cache=self.cache, pos_offset=pos,
                              **self._ml.kw())
        st["done"] = end
        final = end >= S
        if not final:
            self._set_length(slot, end)
        else:
            # Admission pick before the decode pick, as the reference.
            first = self._sampler.pick(logits[slot:slot + 1, S - 1 - done])
        nxt = self._sampler.pick(logits[:, 0])
        self._advance(nxt)
        self._lengths_np[self.active] += 1
        decode_slots = [int(s) for s in np.nonzero(self.active)[0]]
        self._retire(decode_slots)
        fetch = nxt
        if final:
            del self._admissions[slot]
            self._admitted(slot, st, None)
            self._set_length(slot, S)
            self.last_token[slot, 0] = first[0]
            self.active[slot] = True
            fetch = torch.cat([nxt, first])            # one transfer
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

    def evict(self, slot: int) -> None:
        self._admissions.pop(slot, None)   # cancel mid-chunked admit
        self.active[slot] = False
        self._sync_active()
        self._ml.reset(slot)
        self._set_length(slot, 0)
