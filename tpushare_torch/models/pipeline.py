"""Pipeline parallelism for the decoder LM. Counterpart of
``tpushare/models/pipeline.py``.

The stacked layer leaves ([L, ...]) split over the mesh's ``pp`` axis:
stage r holds layers [r*L/P, (r+1)*L/P) (``stage_params``; the
reference's ``param_specs``, ``pipeline.py:45``), the embedding, final
norm and head are replicated. Three schedules, one step interface
(``make_pp_train_step``, ``make_pp_adamw_train_step``):

- ``"gpipe"`` (``pipelined_lm_loss``, reference ``:139``): the M + P - 1
  round fill/drain loop, differentiated by autograd. The reference's one
  ``ppermute`` hop per round is ``_Hop``, an autograd Function over
  ``batch_isend_irecv``: its forward sends to stage r+1 and receives
  from r-1, its backward sends the gradient the other way. Every stage
  runs every round, as the SPMD reference does, and every hop output
  stays in the autograd graph (``_pick``), so each rank's backward walks
  the hops in the same order (T-2 down to 0) and every send meets its
  receive. The loss is masked to the last stage.
- ``"1f1b"`` (``onef1b_loss_and_grads``, reference ``:377``): each
  microbatch's backward runs as soon as its forward leaves the last
  stage; a stage keeps only its chunk inputs (O(P) of them) and
  recomputes the chunk under ``torch.autograd.grad`` for the backward.
- ``"interleaved"`` (``interleaved_loss_and_grads``, reference ``:635``):
  Megatron's virtual stages, v chunks a rank, replaying the static
  timetable of ``build_interleaved_schedule`` (pure Python, copied from
  the reference and held equal to it by a test). Params go in
  ``to_interleaved_storage`` order.

The manual schedules run only the work whose result is used (the SPMD
reference computes every slot and masks it): a stage computes a chunk
forward only when it sends the result on, and the chunk that ends in the
head runs its forward once, inside its backward. Messages are exchanged
only where a valid microbatch travels; both ends read that from the same
static timetable. ``pvary`` has no torch counterpart and is left out.

Under ``sp`` (sequence parallel, ``sp > 1``) each block attends through
ring attention over the sp group with positions offset by the rank's
shard (``_sp_rotary``, reference ``:124``); on sp = 1 the blocks take
``attention``'s flash path, as the reference's factories do. The head
applies ``cfg.final_softcap`` as ``transformer.forward`` does (the
reference's pipeline head leaves it out).

Under ``tp`` (pp x tp x sp x dp, reference ``:819-905``) each stage
holds its layers' Megatron slices (``param_specs``) and ``_block`` runs
``transformer``'s two operators, "f" (``copy_to``) on the inputs of the
column-parallel products and "g" (``tp_matmul``) on ``wo`` and
``w_down``; every rank of a tp group sits at the same stage and replays
the same timetable, so their tp collectives come in the same order
between the pp hops (and again in a remat or manual recompute). ep is
refused: the dense pipeline has no experts (the reference runs it with
ep idle, the batch replicated over ep).

Gradients: layer gradients stay on their stage (and tp rank); the
replicated leaves' are summed over pp; everything, and the loss, is
averaged over dp and sp. The manual schedules accumulate in f32 and cast
to each leaf's dtype at the end.
"""

from __future__ import annotations

import functools
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpushare_torch.models.training import (
    Tree, _sgd_update, _unflatten, apply_adamw, save_sharded, sharded_load,
    tree_leaves, tree_map,
)
from tpushare_torch.models.transformer import (TransformerConfig, copy_to,
                                               layer_windows, tp_matmul)
from tpushare_torch.models.transformer import param_specs as dense_specs
from tpushare_torch.ops.attention import attention
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.q8_expert import _apply_act as _act
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding
from tpushare_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                          data_groups, host_staged)
from tpushare_torch.parallel.ring_attention import ring_attention
from tpushare_torch.parallel.sharding import P

_SCHEDULES = ("gpipe", "1f1b", "interleaved")


# --- layout -----------------------------------------------------------------

def checkpointed(step, specs: Tree, mesh):
    """``step`` with ``trainer.fit``'s checkpoint hooks for its state
    sharded by ``specs`` on ``mesh``: ``save_state`` writes whole leaves
    (``training.save_sharded``), ``load_shardings()`` gives this rank's
    slices of them (``training.sharded_load``)."""
    step.save_state = functools.partial(save_sharded, specs=specs, mesh=mesh)
    step.load_shardings = functools.partial(sharded_load, specs, mesh)
    return step


def param_specs(cfg: TransformerConfig, *, pp: str = "pp",
                tp: str = "tp") -> Tree:
    """The dense specs with the stacked-layer axis split over pp
    (reference ``pipeline.py:45``): a rank's slices are its stage's
    block of layers, Megatron-split over tp."""
    specs = dense_specs(cfg, tp=tp)
    specs["layers"] = {k: P(pp, *tuple(s)[1:])
                       for k, s in specs["layers"].items()}
    return specs


def stage_params(params: Tree, n_stages: int, stage: int) -> Tree:
    """Stage ``stage``'s share of a whole params tree: its block of every
    layer stack (views of the caller's tensors) and the replicated
    leaves as they are."""
    out = dict(params)
    out["layers"] = {}
    for name, leaf in params["layers"].items():
        n = leaf.shape[0] // n_stages
        out["layers"][name] = leaf[stage * n:(stage + 1) * n]
    return out


def interleaved_layer_order(n_layers: int, n_stages: int, v: int
                            ) -> List[int]:
    """Storage permutation for ``schedule="interleaved"`` (reference
    ``pipeline.py:486``): rank s owns model chunks {s, s+P, ...,
    s+(v-1)P} of Lc = L/(P*v) layers each, so storage row r holds model
    layer ``perm[r]`` and rank s's contiguous block is its chunks in
    order."""
    if n_layers % (n_stages * v):
        raise ValueError(f"{n_layers} layers not divisible into "
                         f"{n_stages}x{v} chunks")
    lc = n_layers // (n_stages * v)
    perm = []
    for s in range(n_stages):
        for j in range(v):
            q = j * n_stages + s
            perm.extend(range(q * lc, (q + 1) * lc))
    return perm


def to_interleaved_storage(params: Tree, n_stages: int, v: int) -> Tree:
    """A params tree with its layer stacks permuted into interleaved
    storage order (once, before ``stage_params``)."""
    some = next(iter(params["layers"].values()))
    perm = torch.as_tensor(interleaved_layer_order(some.shape[0], n_stages,
                                                   v), device=some.device)
    out = dict(params)
    out["layers"] = {k: a[perm] for k, a in params["layers"].items()}
    return out


def build_interleaved_schedule(n_stages: int, v: int, M: int):
    """Static interleaved-1F1B timetable and buffer capacities (reference
    ``pipeline.py:522``, the same pure Python): Megatron's per-rank op
    order (warmup of (P-s-1)*2 + (v-1)*P forwards, 1F1B pairs, drain;
    chunks cycling in groups of P microbatches) list-scheduled against
    the true dependencies, one op per rank per slot, a message sent at
    slot t usable at t+1. Returns tables f_j/f_m/b_j/b_m [T][P] (-1 =
    idle), the mailbox / ring capacities qf/qb/rc the reference's mod-M
    buffers need, per-rank bubble counts, and T."""
    P, D = n_stages, n_stages * v
    if M % P:
        raise ValueError(f"interleaved schedule needs microbatches "
                         f"divisible by stages (M={M}, P={P})")
    total = v * M

    def fwd_op(k):   # Megatron get_model_chunk_id order, forward
        return ((k // P) % v, (k // (P * v)) * P + (k % P))

    def bwd_op(k):   # backward visits chunks in reverse
        return (v - 1 - ((k // P) % v), (k // (P * v)) * P + (k % P))

    ops = []
    for s in range(P):
        warm = min((P - s - 1) * 2 + (v - 1) * P, total)
        seq = [("F",) + fwd_op(i) for i in range(warm)]
        nf, nb = warm, 0
        while nf < total or nb < total:
            if nf < total:
                seq.append(("F",) + fwd_op(nf))
                nf += 1
            if nb < total:
                seq.append(("B",) + bwd_op(nb))
                nb += 1
        ops.append(seq)

    done_f: Dict[Tuple[int, int], int] = {}
    done_b: Dict[Tuple[int, int], int] = {}
    ptr = [0] * P
    bubbles = [0] * P
    f_j, f_m, b_j, b_m = [], [], [], []
    t = 0
    while any(ptr[s] < len(ops[s]) for s in range(P)):
        rows = [[-1] * P for _ in range(4)]
        fired = []
        for s in range(P):
            if ptr[s] >= len(ops[s]):
                continue
            kind, j, m = ops[s][ptr[s]]
            q = j * P + s
            if kind == "F":
                ready = q == 0 or done_f.get((q - 1, m), t) <= t - 1
            else:
                ready = done_f.get((q, m), t) <= t - 1 and (
                    q == D - 1 or done_b.get((q + 1, m), t) <= t - 1)
            if ready:
                fired.append((s, kind, j, m, q))
            else:
                bubbles[s] += 1
        if not fired:
            raise RuntimeError(
                f"interleaved schedule deadlocked at slot {t} "
                f"(P={P}, v={v}, M={M})")
        for s, kind, j, m, q in fired:
            if kind == "F":
                done_f[(q, m)] = t
                rows[0][s], rows[1][s] = j, m
            else:
                done_b[(q, m)] = t
                rows[2][s], rows[3][s] = j, m
            ptr[s] += 1
        f_j.append(rows[0])
        f_m.append(rows[1])
        b_j.append(rows[2])
        b_m.append(rows[3])
        t += 1

    # Mod-ring capacities, grown until reuse is provably clobber-free
    # (the reference's fixed-size buffers; the port's mailboxes are
    # dicts keyed by (chunk, microbatch) and need no capacity).
    def grow(cap, safe):
        while cap < M and not safe(cap):
            cap += 1
        return cap

    def qf_safe(cap):
        return all(done_f.get((q, m - cap), -1) <= done_f[(q - 1, m)]
                   for q in range(1, D) for m in range(cap, M))

    def qb_safe(cap):
        return all(done_b.get((q, m - cap), -1) <= done_b[(q + 1, m)]
                   for q in range(D - 1) for m in range(cap, M))

    def rc_safe(cap):
        return all(done_b.get((q, m - cap), -1) < done_f[(q, m)]
                   for q in range(D) for m in range(cap, M))

    return {
        "f_j": f_j, "f_m": f_m, "b_j": b_j, "b_m": b_m, "T": t,
        "qf": grow(1, qf_safe), "qb": grow(1, qb_safe),
        "rc": grow(1, rc_safe), "bubbles": bubbles,
    }


def local_layer_windows(cfg: TransformerConfig, n_stages: int, stage: int,
                        interleaved_v: Optional[int] = None
                        ) -> Optional[List[int]]:
    """This stage's per-layer sliding windows in storage order (0 =
    global), or None when cfg has none (reference ``pipeline.py:105``):
    the model-order rule of ``transformer.layer_windows``, permuted for
    interleaved storage, cut to the stage's block."""
    wls = layer_windows(cfg)
    if wls is None:
        return None
    if interleaved_v is not None:
        wls = [wls[i] for i in interleaved_layer_order(
            cfg.n_layers, n_stages, interleaved_v)]
    n = cfg.n_layers // n_stages
    return wls[stage * n:(stage + 1) * n]


def _sp_rotary(S: int, Bm: int, cfg: TransformerConfig, sp_group,
               device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) of a [Bm, S] microbatch whose sequence may be this
    rank's sp shard, starting at sp_rank * S (reference ``:124``)."""
    positions = torch.arange(S, device=device)[None, :]
    if sp_group is not None:
        positions = positions + dist.get_rank(sp_group) * S
    return rotary_embedding(positions.expand(Bm, S), cfg.head_dim,
                            base=cfg.rope_base, scaling=cfg.rope_scaling,
                            dtype=torch.float32)


def _block(x, layer, cfg: TransformerConfig, cos, sin, sp_group, w,
           attn_impl: str, tp_group=None):
    """One transformer block without a cache (reference ``:54``): ring
    attention over ``sp_group`` when given, else ``attention``; ``w`` is
    the layer's window (0 or None: global); the Megatron operators over
    ``tp_group``."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    h = copy_to(rms_norm(x, layer["ln1"], eps=cfg.norm_eps,
                         offset=cfg.norm_offset), tp_group)
    H = layer["wq"].shape[-1] // Dh
    Hkv = layer["wk"].shape[-1] // Dh
    q = apply_rotary((h @ layer["wq"]).reshape(B, S, H, Dh), cos, sin)
    k = apply_rotary((h @ layer["wk"]).reshape(B, S, Hkv, Dh), cos, sin)
    v = (h @ layer["wv"]).reshape(B, S, Hkv, Dh)
    if sp_group is not None:
        attn = ring_attention(
            q, k, v, group=sp_group, scale=cfg.attn_scale, window=w,
            attn_softcap=cfg.attn_softcap,
            impl="dense" if attn_impl == "reference" else "auto")
    else:
        attn = attention(q, k, v, causal=True, scale=cfg.attn_scale,
                         window=w, attn_softcap=cfg.attn_softcap,
                         impl=attn_impl)
    o = tp_matmul(attn.reshape(B, S, H * Dh), layer["wo"], tp_group)
    if cfg.post_norms:
        o = rms_norm(o, layer["ln_post_attn"], eps=cfg.norm_eps,
                     offset=cfg.norm_offset)
    x = x + o
    h = copy_to(rms_norm(x, layer["ln2"], eps=cfg.norm_eps,
                         offset=cfg.norm_offset), tp_group)
    ff = tp_matmul(_act(cfg.act, h @ layer["w_gate"]) * (h @ layer["w_up"]),
                   layer["w_down"], tp_group)
    if cfg.post_norms:
        ff = rms_norm(ff, layer["ln_post_ffw"], eps=cfg.norm_eps,
                      offset=cfg.norm_offset)
    return x + ff


def _chunk(x, layers: Dict[str, torch.Tensor], windows, cfg, cos, sin,
           sp_group, attn_impl: str, remat: bool = False, tp_group=None):
    """x through the stacked ``layers`` in order (each under
    ``torch.utils.checkpoint`` with ``remat``)."""
    n = next(iter(layers.values())).shape[0]
    for li in range(n):
        layer = {k: a[li] for k, a in layers.items()}
        w = None if windows is None else windows[li]
        if remat:
            x = checkpoint(_block, x, layer, cfg, cos, sin, sp_group, w,
                           attn_impl, tp_group, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _block(x, layer, cfg, cos, sin, sp_group, w, attn_impl,
                       tp_group)
    return x


def _embed(params, toks, cfg: TransformerConfig):
    x = params["embed"][toks.long()].to(cfg.dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                             device=x.device)
    return x


def _head_nll(y, final_norm, head, tgt, cfg: TransformerConfig):
    """Mean next-token nll of hidden states y against tgt (the head of
    ``transformer.forward`` and ``training.xent_loss``)."""
    x = rms_norm(y, final_norm, eps=cfg.norm_eps, offset=cfg.norm_offset)
    unembed = (head.T if cfg.tie_embeddings else head).to(cfg.dtype)
    logits = (x @ unembed).float()
    if cfg.final_softcap is not None:
        logits = cfg.final_softcap * torch.tanh(logits / cfg.final_softcap)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, tgt.long()[..., None]).mean()


# --- point-to-point ----------------------------------------------------------

def _peer(group, r: int) -> int:
    return dist.get_global_rank(group, r)


def _exchange(sends, recvs, group) -> List[torch.Tensor]:
    """One batch of point-to-point messages within ``group``: ``sends``
    [(tensor, group rank)], ``recvs`` [(like tensor, group rank)];
    returns the received tensors. A message to this rank itself is
    handed over without a transfer."""
    me = dist.get_rank(group) if group is not None else 0
    out = [None] * len(recvs)
    local = [t for t, r in sends if r == me]
    some = (sends or recvs or [(None, None)])[0][0]
    staged = some is not None and group is not None and \
        host_staged(some, group)
    ops = [dist.P2POp(dist.isend, t.cpu() if staged else t.contiguous(),
                      _peer(group, r), group) for t, r in sends if r != me]
    remote = []
    for i, (like, r) in enumerate(recvs):
        if r == me:
            out[i] = local.pop(0)
        else:
            out[i] = torch.empty_like(like, device="cpu" if staged
                                      else like.device)
            remote.append(i)
            ops.append(dist.P2POp(dist.irecv, out[i], _peer(group, r),
                                  group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for i in remote if staged else ():
        out[i] = out[i].to(some.device)
    return out


class _Hop(torch.autograd.Function):
    """GPipe's hop (the reference's non-cyclic ``ppermute`` s -> s+1):
    the forward sends x to stage+1 (the last stage sends nothing) and
    returns what stage-1 sent (zeros on stage 0); the backward sends the
    gradient to stage-1 and returns what stage+1 sent back."""

    @staticmethod
    def forward(ctx, x, group, stage, n_stages):
        ctx.group, ctx.stage, ctx.n = group, stage, n_stages
        sends = [(x, stage + 1)] if stage < n_stages - 1 else []
        recvs = [(x, stage - 1)] if stage > 0 else []
        got = _exchange(sends, recvs, group)
        return got[0] if got else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        sends = [(g, ctx.stage - 1)] if ctx.stage > 0 else []
        recvs = [(g, ctx.stage + 1)] if ctx.stage < ctx.n - 1 else []
        got = _exchange(sends, recvs, ctx.group)
        return (got[0] if got else torch.zeros_like(g)), None, None, None


def _pick(cond: bool, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a if cond else b`` as a ``torch.where``, so both stay in the
    autograd graph (the other one gets a zero gradient): the reference's
    ``jnp.where(stage == ...)``, which keeps every rank's backward walking
    every hop."""
    return torch.where(torch.tensor(cond, device=a.device), a, b)


# --- the schedules -------------------------------------------------------------

class _Stage:
    """What every schedule reads about this rank: its stage, the pp, sp
    and tp groups, the microbatches, and the rotary tables."""

    def __init__(self, params, inputs, targets, cfg: TransformerConfig, *,
                 pp_group, sp_group, n_microbatches: int, attn_impl: str,
                 tp_group=None):
        self.cfg, self.pp, self.sp, self.tp = cfg, pp_group, sp_group, \
            tp_group
        self.P = 1 if pp_group is None else dist.get_world_size(pp_group)
        self.s = 0 if pp_group is None else dist.get_rank(pp_group)
        M = n_microbatches
        B, S = inputs.shape
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} "
                             f"microbatches")
        self.M, self.Bm, self.S = M, B // M, S
        self.inputs = inputs.reshape(M, self.Bm, S)
        self.targets = targets.reshape(M, self.Bm, S)
        self.cos, self.sin = _sp_rotary(S, self.Bm, cfg, sp_group,
                                        inputs.device)
        self.params = params
        self.attn_impl = attn_impl
        self.head_key = "embed" if cfg.tie_embeddings else "unembed"

    def chunk(self, x, layers, windows, remat=False):
        return _chunk(x, layers, windows, self.cfg, self.cos, self.sin,
                      self.sp, self.attn_impl, remat, self.tp)


def pipelined_lm_loss(params, inputs: torch.Tensor, targets: torch.Tensor,
                      cfg: TransformerConfig, *, pp_group, sp_group=None,
                      n_microbatches: int, attn_impl: str = "auto",
                      tp_group=None) -> torch.Tensor:
    """GPipe (reference ``pipeline.py:139``): this rank's term of the
    next-token loss through the fill/drain loop; inputs/targets [B, S]
    aligned (this rank's dp/sp shard), B divisible by n_microbatches,
    ``params`` this stage's (``stage_params``). The last stage's term is
    its mean nll; the others' are 0 (their outputs join the graph with a
    zero weight). Summed over pp it is the loss; every rank must
    backward its own term (the hops exchange gradients)."""
    st = _Stage(params, inputs, targets, cfg, pp_group=pp_group,
                sp_group=sp_group, n_microbatches=n_microbatches,
                attn_impl=attn_impl, tp_group=tp_group)
    P, s, M = st.P, st.s, st.M
    last = s == P - 1
    wls = local_layer_windows(cfg, P, s)
    remat = cfg.remat and torch.is_grad_enabled()
    x_mb = _embed(params, st.inputs, cfg)
    inflight = torch.zeros((st.Bm, st.S, cfg.d_model), dtype=cfg.dtype,
                           device=inputs.device)
    outs = []
    T = M + P - 1
    for t in range(T):
        inp = _pick(s == 0, x_mb[min(t, M - 1)], inflight)
        act = st.chunk(inp, params["layers"], wls, remat)
        if t >= P - 1:
            outs.append(act)
        if t < T - 1:
            inflight = _Hop.apply(act, pp_group, s, P)
    y = torch.stack(outs).reshape(M * st.Bm, st.S, cfg.d_model)
    if not last:
        return y.sum() * 0.0
    return _head_nll(y, params["final_norm"], params[st.head_key],
                     targets, cfg)


class _Accum:
    """f32 gradient accumulators of the manual schedules and their
    closing sums (reference ``_ManualVJPShared``, ``pipeline.py:235``)."""

    def __init__(self, st: _Stage, layers: Tree):
        self.st = st
        p = st.params
        z = lambda t: torch.zeros(t.shape, dtype=torch.float32,  # noqa: E731
                                  device=t.device)
        self.layers = tree_map(z, layers)
        self.embed = z(p["embed"])
        self.final_norm = z(p["final_norm"])
        self.unembed = None if st.cfg.tie_embeddings else z(p["unembed"])
        self.loss = torch.zeros((), dtype=torch.float32,
                                device=p["embed"].device)
        # Autograd leaves sharing the params' storage.
        self.v_fn = p["final_norm"].detach().requires_grad_()
        self.v_head = p[st.head_key].detach().requires_grad_()

    def head_acc(self):
        return self.embed if self.st.cfg.tie_embeddings else self.unembed

    def embed_grad(self, toks, dx):
        """Close the embedding gather on stage 0: scatter-add dx (times
        the embedding scale) into the embed rows."""
        cfg = self.st.cfg
        if cfg.embed_scale:
            dx = dx * torch.tensor(cfg.d_model ** 0.5, dtype=cfg.dtype,
                                   device=dx.device)
        self.embed.index_add_(0, toks.reshape(-1).long(),
                              dx.reshape(-1, dx.shape[-1]).float())

    def chunk_grads(self, x_res, layers: Dict[str, torch.Tensor], windows,
                    acc_layers, m: int, dy=None):
        """Recompute a chunk from its stored input with autograd and
        backward it: from ``dy`` (an interior chunk) or, with dy None,
        through the head and microbatch m's nll / M (the chunk that ends
        the model). Accumulates the layer (and head) gradients; returns
        dx."""
        st = self.st
        x = x_res.detach().requires_grad_()
        names = sorted(layers)
        leaves = [layers[k].detach().requires_grad_() for k in names]
        with torch.enable_grad():
            y = st.chunk(x, dict(zip(names, leaves)), windows)
            if dy is None:
                nll = _head_nll(y, self.v_fn, self.v_head, st.targets[m],
                                st.cfg)
                extra = [self.v_fn, self.v_head]
                grads = torch.autograd.grad(nll / st.M,
                                            [x] + leaves + extra)
                self.loss += nll.detach().float() / st.M
                self.final_norm += grads[-2].float()
                self.head_acc().add_(grads[-1].float())
                grads = grads[:-2]
            else:
                grads = torch.autograd.grad(y, [x] + leaves,
                                            grad_outputs=dy)
        for k, g in zip(names, grads[1:]):
            acc_layers[k] += g.float()
        return grads[0]

    def finalize(self, pp_group, data_groups):
        """(global loss, grads in each leaf's dtype)."""
        grads = {"layers": self.layers, "embed": self.embed,
                 "final_norm": self.final_norm}
        if self.unembed is not None:
            grads["unembed"] = self.unembed
        reduce_grads(grads, self.loss, pp_group, data_groups)
        like = {k: self.st.params[k] for k in grads}
        return self.loss, _unflatten(like, [g.to(t.dtype) for g, t in zip(
            tree_leaves(grads), tree_leaves(like))])


def reduce_grads(grads: Tree, loss: torch.Tensor, pp_group,
                 data_groups) -> None:
    """In place: the replicated leaves' gradients (all but ``layers``)
    and the loss summed over pp, then everything averaged over each data
    group in turn."""
    if pp_group is not None:
        for t in [loss] + [t for k, v in grads.items() if k != "layers"
                           for t in tree_leaves({k: v})]:
            dist.all_reduce(t, group=pp_group)
    for g in data_groups:
        n = dist.get_world_size(g)
        for t in tree_leaves(grads) + [loss]:
            dist.all_reduce(t, group=g)
            t.div_(n)


def gpipe_grads(term_fn, params: Tree, pp_group, data_groups):
    """(global loss, grads) of a GPipe loss: ``term_fn(params)`` is this
    rank's term, every rank backwards its own (the hops exchange the
    gradients between stages), then ``reduce_grads``. Off the last
    stage the head's leaves get zero gradients."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    term = term_fn(_unflatten(params, leaves))
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(
        torch.autograd.grad(term, leaves, allow_unused=True), leaves)]
    loss = term.detach().float().clone()
    tree = _unflatten(params, grads)
    reduce_grads(tree, loss, pp_group, data_groups)
    return loss, tree


def onef1b_loss_and_grads(params, inputs: torch.Tensor,
                          targets: torch.Tensor, cfg: TransformerConfig, *,
                          pp_group, sp_group=None, data_groups=(),
                          n_microbatches: int, attn_impl: str = "auto",
                          tp_group=None):
    """1F1B with a manual per-microbatch backward (reference
    ``pipeline.py:377``). Round r, stage s of P: the forward of
    microbatch r - s, the backward of microbatch r - (2P - 2 - s); the
    last stage runs both on the same microbatch in one round (its
    forward happens inside the backward's recompute, with the head). A
    stage keeps at most min(2P - 1, M) chunk inputs and no activations.
    Returns (global mean loss, grads) ready to apply."""
    st = _Stage(params, inputs, targets, cfg, pp_group=pp_group,
                sp_group=sp_group, n_microbatches=n_microbatches,
                attn_impl=attn_impl, tp_group=tp_group)
    P, s, M = st.P, st.s, st.M
    layers = params["layers"]
    wls = local_layer_windows(cfg, P, s)
    acc = _Accum(st, layers)
    ring: Dict[int, torch.Tensor] = {}
    like = torch.empty((st.Bm, st.S, cfg.d_model), dtype=cfg.dtype,
                       device=inputs.device)
    fwd_msg = bwd_msg = None

    def valid(m):
        return 0 <= m < M

    for r in range(M + 2 * P - 2):
        m_f = r - s
        y = None
        if valid(m_f):
            x_in = _embed(params, st.inputs[m_f], cfg) if s == 0 else fwd_msg
            ring[m_f] = x_in.detach()
            if s < P - 1:
                with torch.no_grad():
                    y = st.chunk(x_in, layers, wls)
        m_b = r - (2 * P - 2 - s)
        dx = None
        if valid(m_b):
            dx = acc.chunk_grads(ring.pop(m_b), layers, wls, acc.layers,
                                 m_b, dy=None if s == P - 1 else bwd_msg)
            if s == 0:
                acc.embed_grad(st.inputs[m_b], dx)
        sends, recvs = [], []
        if y is not None:
            sends.append((y, s + 1))
        if dx is not None and s > 0:
            sends.append((dx, s - 1))
        up = s > 0 and valid(r - (s - 1))                # stage s-1's fwd
        dn = s < P - 1 and valid(r - (2 * P - 3 - s))    # stage s+1's bwd
        if up:
            recvs.append((like, s - 1))
        if dn:
            recvs.append((like, s + 1))
        got = _exchange(sends, recvs, pp_group) if sends or recvs else []
        fwd_msg = got.pop(0) if up else None
        bwd_msg = got.pop(0) if dn else None
    return acc.finalize(pp_group, data_groups)


def interleaved_loss_and_grads(params, inputs: torch.Tensor,
                               targets: torch.Tensor,
                               cfg: TransformerConfig, *, pp_group,
                               sp_group=None, data_groups=(),
                               n_microbatches: int, n_chunks: int = 2,
                               attn_impl: str = "auto", tp_group=None):
    """Interleaved 1F1B, v = n_chunks virtual stages a rank (reference
    ``pipeline.py:635``): each slot a rank replays its row of
    ``build_interleaved_schedule``: at most one chunk forward and one
    chunk backward. Activations hop to rank+1 cyclically (P-1 wraps to
    0, where the chunk group advances), gradients the other way; the
    mailboxes and the residual store are dicts keyed by (chunk,
    microbatch). ``params["layers"]`` in ``to_interleaved_storage``
    order. Returns (global mean loss, grads)."""
    v, M = n_chunks, n_microbatches
    st = _Stage(params, inputs, targets, cfg, pp_group=pp_group,
                sp_group=sp_group, n_microbatches=M, attn_impl=attn_impl,
                tp_group=tp_group)
    P, s = st.P, st.s
    D = P * v
    sched = build_interleaved_schedule(P, v, M)
    some = next(iter(params["layers"].values()))
    lc = some.shape[0] // v
    chunks = [{k: a[j * lc:(j + 1) * lc] for k, a in
               params["layers"].items()} for j in range(v)]
    wls = local_layer_windows(cfg, P, s, interleaved_v=v)
    wins = [None if wls is None else wls[j * lc:(j + 1) * lc]
            for j in range(v)]
    acc = _Accum(st, params["layers"])
    acc_chunks = [{k: a[j * lc:(j + 1) * lc] for k, a in
                   acc.layers.items()} for j in range(v)]
    like = torch.empty((st.Bm, st.S, cfg.d_model), dtype=cfg.dtype,
                       device=inputs.device)
    fwd_mail: Dict[Tuple[int, int], torch.Tensor] = {}
    bwd_mail: Dict[Tuple[int, int], torch.Tensor] = {}
    ring: Dict[Tuple[int, int], torch.Tensor] = {}
    nxt, prv = (s + 1) % P, (s - 1) % P

    def fwd_send(t, rank):
        """(destination chunk, microbatch) of rank's forward message at
        slot t, or None."""
        j, m = sched["f_j"][t][rank], sched["f_m"][t][rank]
        if j < 0 or j * P + rank == D - 1:
            return None
        return (j + 1 if rank == P - 1 else j), m

    def bwd_send(t, rank):
        j, m = sched["b_j"][t][rank], sched["b_m"][t][rank]
        if j < 0 or j * P + rank == 0:
            return None
        return (j - 1 if rank == 0 else j), m

    for t in range(sched["T"]):
        fj, fm = sched["f_j"][t][s], sched["f_m"][t][s]
        y = None
        if fj >= 0:
            q = fj * P + s
            x_in = (_embed(params, st.inputs[fm], cfg) if q == 0
                    else fwd_mail.pop((fj, fm)))
            ring[(fj, fm)] = x_in.detach()
            if q < D - 1:
                with torch.no_grad():
                    y = st.chunk(x_in, chunks[fj], wins[fj])
        bj, bm = sched["b_j"][t][s], sched["b_m"][t][s]
        dx = None
        if bj >= 0:
            q = bj * P + s
            dy = None if q == D - 1 else bwd_mail.pop((bj, bm))
            dx = acc.chunk_grads(ring.pop((bj, bm)), chunks[bj], wins[bj],
                                 acc_chunks[bj], bm, dy=dy)
            if q == 0:
                acc.embed_grad(st.inputs[bm], dx)
        sends, recvs, keys = [], [], []
        if y is not None:
            sends.append((y, nxt))
        if dx is not None and bwd_send(t, s) is not None:
            sends.append((dx, prv))
        f_in, b_in = fwd_send(t, prv), bwd_send(t, nxt)
        if f_in is not None:
            recvs.append((like, prv))
            keys.append((fwd_mail, f_in))
        if b_in is not None:
            recvs.append((like, nxt))
            keys.append((bwd_mail, b_in))
        if sends or recvs:
            for (box, key), got in zip(keys, _exchange(sends, recvs,
                                                       pp_group)):
                box[key] = got
    return acc.finalize(pp_group, data_groups)


# --- the steps ------------------------------------------------------------------

def _mesh_setup(mesh, schedule: str):
    """(pp group, sp group or None, data groups, tp group or None) of
    the pp step over ``mesh``; ep and fsdp above 1 raise."""
    if schedule not in _SCHEDULES:
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    if axis_size(mesh, "ep") > 1:
        raise NotImplementedError(
            "dense pipeline with ep > 1: the dense LM has no experts to "
            "split (models.moe_pipeline runs pp x ep)")
    if axis_size(mesh, "fsdp") > 1:
        raise NotImplementedError("pipeline with fsdp > 1: the reference "
                                  "composes pp with dp, sp and tp only")
    sp = axis_group(mesh, "sp") if axis_size(mesh, "sp") > 1 else None
    return axis_group(mesh, "pp"), sp, data_groups(mesh), \
        axis_group(mesh, "tp")


def shard_pp_batch(tokens: torch.Tensor, mesh):
    """This rank's (inputs, targets) of tokens [B, S+1]: the shift first,
    rows over dp, the sequence over sp (every pp stage sees the same)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    dp, sp = axis_size(mesh, "dp"), axis_size(mesh, "sp")
    if B % dp or S % sp:
        raise ValueError(f"batch [{B}, {S}] does not shard over dp={dp}, "
                         f"sp={sp}")
    i, j = axis_rank(mesh, "dp"), axis_rank(mesh, "sp")
    rows = slice(i * B // dp, (i + 1) * B // dp)
    cols = slice(j * S // sp, (j + 1) * S // sp)
    return inputs[rows, cols].contiguous(), targets[rows, cols].contiguous()


def pp_loss_and_grads(params, tokens: torch.Tensor, cfg, mesh, *,
                      schedule: str, n_microbatches: int, n_chunks: int = 2,
                      attn_impl: str = "auto"):
    """(global mean loss, grads of this stage's params) of one batch
    tokens [B, S+1] under ``schedule`` (reference ``_pp_loss_and_grads``,
    ``pipeline.py:789``)."""
    pp, sp, data, tp = _mesh_setup(mesh, schedule)
    inputs, targets = shard_pp_batch(tokens, mesh)
    kw = dict(pp_group=pp, sp_group=sp, n_microbatches=n_microbatches,
              attn_impl=attn_impl, tp_group=tp)
    if schedule == "interleaved":
        return interleaved_loss_and_grads(params, inputs, targets, cfg,
                                          data_groups=data,
                                          n_chunks=n_chunks, **kw)
    if schedule == "1f1b":
        return onef1b_loss_and_grads(params, inputs, targets, cfg,
                                     data_groups=data, **kw)
    return gpipe_grads(lambda p: pipelined_lm_loss(p, inputs, targets,
                                                   cfg, **kw),
                       params, pp, data)


def make_pp_train_step(cfg: TransformerConfig, mesh, *, n_microbatches: int,
                       lr: float = 1e-3, schedule: str = "gpipe",
                       n_chunks: int = 2, attn_impl: str = "auto"):
    """SGD step over a pp x tp x sp x dp mesh (reference
    ``pipeline.py:819``): step(params, tokens [B, S+1]) -> (params,
    global mean loss), params this rank's (``stage_params``, or
    ``sharding.shard_tree`` of ``param_specs`` under tp; in
    ``to_interleaved_storage`` order for "interleaved", whose M must
    divide by P), updated in place."""
    _mesh_setup(mesh, schedule)

    def step(params, tokens):
        loss, grads = pp_loss_and_grads(
            params, tokens, cfg, mesh, schedule=schedule,
            n_microbatches=n_microbatches, n_chunks=n_chunks,
            attn_impl=attn_impl)
        return _sgd_update(params, grads, lr), loss

    return checkpointed(step, param_specs(cfg), mesh)


def make_pp_adamw_train_step(cfg: TransformerConfig, mesh, *,
                             n_microbatches: int, lr: float = 1e-3,
                             weight_decay: float = 0.0,
                             schedule: str = "1f1b", n_chunks: int = 2,
                             attn_impl: str = "auto"):
    """AdamW over the pp x tp x sp x dp mesh (reference
    ``pipeline.py:864``): the moments mirror this rank's params
    (``training.adamw_init`` of them), so a rank holds f32 moments for
    its own slices of its own layers only.
    step(params, opt_state, tokens) -> (params, opt_state, loss)."""
    _mesh_setup(mesh, schedule)

    def step(params, opt_state, tokens):
        loss, grads = pp_loss_and_grads(
            params, tokens, cfg, mesh, schedule=schedule,
            n_microbatches=n_microbatches, n_chunks=n_chunks,
            attn_impl=attn_impl)
        params, state = apply_adamw(params, grads, opt_state, lr=lr,
                                    weight_decay=weight_decay)
        return params, state, loss

    return checkpointed(step, param_specs(cfg), mesh)
