"""Training steps for the transformer LM. Counterpart of
``tpushare/models/training.py``.

One loss (``xent_loss``), one gradient routine (``value_and_grad``) and
two update rules (SGD, AdamW), run two ways: single device
(``sgd_train_step``, ``adamw_train_step``) and SPMD over a dp x sp x tp
mesh (``make_spmd_train_step``, ``make_adamw_spmd_train_step``: batch
rows over dp, sequence over sp through ring attention, or Ulysses
all-to-all attention with ``sp_impl="a2a"``, and the Megatron split of
``transformer.param_specs`` over tp: each rank holds its slices,
``sharding.shard_tree``, and AdamW's moments shard like them,
``opt_state_specs``). ``tp_gather`` rebuilds whole trees from the
slices; ``save_sharded`` writes a sharded state as whole leaves and
``sharded_load`` reads any rank's slices back (``trainer.fit``'s
checkpoints of the SPMD and pipeline steps). The four steps take the loss
(``loss_fn``) and, under SPMD, the sharding (``shard_fn``) as
parameters; ``moe.py``'s steps are these with its own loss, specs and
``moe.shard_pairs``. The manual fsdp steps (``make_fsdp_train_step``,
``make_fsdp_stream_train_step``, ``make_fsdp_stream_adamw_step``) keep
each rank's slice of flat, padded leaves and gather them per step (or
per layer) over the mesh's ``fsdp`` axis.

Gradients under SPMD: the reference makes the loss global (pmean over
the data axes) before ``jax.grad`` and lets the shard_map transpose
insert the reductions (``training.py:10-16``). The port takes each
rank's local mean and backwards it — the ring backward returns every
K/V chunk's gradient to the rank that owns it, the tp operators of
``transformer`` ("f" and "g") make every rank of a tp group hold the
whole gradient of its replicated leaves and its own slices' — then
sums each leaf's gradient over the data axes (``mesh.data_axes``) it
is not split over and divides by their size: the gradient of the same
global mean, since the shards are equal. Never over tp: its ranks hold
one loss. The next-token shift happens before sharding (``:110-114``),
so every shard holds aligned (input, target) pairs.

Updates use f32 math and keep each parameter's dtype (``:65-71``,
``:456-463``); AdamW increments ``count`` before its update. Unlike the
reference, which returns new arrays, the port updates parameters and
AdamW moments IN PLACE (a full-width model holds its parameters once)
and returns the same dicts. Trees are the nested dicts of
``transformer.init_params``; leaves are walked in sorted-key order, the
same on every rank.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpushare_torch.models.transformer import (
    ParallelCtx, TransformerConfig, forward, init_params, param_specs,
)
from tpushare_torch.parallel.mesh import (axis_group, axis_rank, axis_size,
                                          data_axes, mesh_layout)
from tpushare_torch.parallel.sharding import (P, shard_tree, spec_axes,
                                              walk_specs)
from tpushare_torch.utils import checkpoint
from tpushare_torch.utils.checkpoint import FlatShard

Tree = Dict[str, Any]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(tree_leaves(val) if isinstance(val, dict) else [val])
    return out


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """A nested dict of the same keys with ``fn`` applied to each tensor
    (``fn(tree)`` for a lone tensor)."""
    if not isinstance(tree, dict):
        return fn(tree)
    return {k: tree_map(fn, v) for k, v in tree.items()}


def _unflatten(like: Tree, leaves: List[torch.Tensor]) -> Tree:
    """``leaves`` (in ``tree_leaves`` order) put back into ``like``'s
    nesting."""
    it = iter(leaves)

    def build(t):
        return {k: build(t[k]) if isinstance(t[k], dict) else next(it)
                for k in sorted(t)}
    return build(like)


def xent_loss(params: Tree, inputs: torch.Tensor, targets: torch.Tensor,
              cfg: TransformerConfig, *, pctx: Optional[ParallelCtx] = None,
              attn_impl: str = "auto", layers_hook=None) -> torch.Tensor:
    """Mean cross-entropy of forward(inputs) against aligned ``targets``
    (both [B, S]) — this rank's local mean; the SPMD steps average it
    over the mesh."""
    logits, _ = forward(params, inputs, cfg, pctx=pctx, attn_impl=attn_impl,
                        layers_hook=layers_hook)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None])
    return nll.mean()


def lm_loss(params: Tree, tokens: torch.Tensor, cfg: TransformerConfig, *,
            pctx: Optional[ParallelCtx] = None,
            attn_impl: str = "auto") -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, S+1]."""
    return xent_loss(params, tokens[:, :-1], tokens[:, 1:], cfg, pctx=pctx,
                     attn_impl=attn_impl)


def value_and_grad(loss_fn: Callable, tree: Tree, *args,
                   **kw) -> Tuple[torch.Tensor, Tree]:
    """(loss, gradient tree) of ``loss_fn(tree, *args, **kw)`` with
    respect to ``tree`` only (the counterpart of ``jax.value_and_grad``
    on the first argument): its tensors are taken as fresh autograd
    leaves sharing their storage, so the caller's tensors are left as
    they were, and nothing else gets a gradient."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(tree)]
    loss = loss_fn(_unflatten(tree, leaves), *args, **kw)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), _unflatten(tree, list(grads))


def loss_and_grads(params: Tree, inputs: torch.Tensor,
                   targets: torch.Tensor, cfg: TransformerConfig, *,
                   pctx: Optional[ParallelCtx] = None,
                   attn_impl: str = "auto") -> Tuple[torch.Tensor, Tree]:
    """(loss, gradient tree) of ``xent_loss`` at ``params``."""
    return value_and_grad(xent_loss, params, inputs, targets, cfg,
                          pctx=pctx, attn_impl=attn_impl)


def _sgd_update(params: Tree, grads: Tree, lr: float) -> Tree:
    """The one SGD rule every step shares: p - lr * g in f32, stored back
    in p's dtype, in place."""
    with torch.no_grad():
        for p, g in zip(tree_leaves(params), tree_leaves(grads)):
            p.copy_(p.float() - lr * g.float())
    return params


def sgd_train_step(params: Tree, tokens: torch.Tensor, cfg, *,
                   lr: float = 1e-3, loss_fn: Callable = xent_loss,
                   **loss_kw) -> Tuple[Tree, torch.Tensor]:
    """One single-device SGD step on tokens [B, S+1]: (params, loss).
    ``loss_fn(params, inputs, targets, cfg, **loss_kw)`` is the loss of
    the aligned pairs (the MoE steps pass ``moe.xent_loss``)."""
    loss, grads = value_and_grad(loss_fn, params, tokens[:, :-1],
                                 tokens[:, 1:], cfg, **loss_kw)
    return _sgd_update(params, grads, lr), loss


def _adamw_update(params: Tree, grads: Tree, mu: Tree, nu: Tree,
                  count: torch.Tensor, *, lr: float, b1: float = 0.9,
                  b2: float = 0.999, eps: float = 1e-8,
                  weight_decay: float = 0.0) -> None:
    """The one elementwise AdamW rule (decoupled weight decay,
    bias-corrected moments, f32 math, parameter dtype kept), in place on
    params, mu and nu. ``count`` is the ALREADY-incremented step number
    (a 0-d tensor: the bias corrections stay on the device)."""
    c = count.float()
    bc1, bc2 = 1 - b1 ** c, 1 - b2 ** c
    with torch.no_grad():
        for p, g, m, n in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(mu), tree_leaves(nu)):
            g = g.float()
            m.mul_(b1).add_((1 - b1) * g)
            n.mul_(b2).add_((1 - b2) * g * g)
            step = (m / bc1) / (torch.sqrt(n / bc2) + eps)
            p32 = p.float()
            p.copy_(p32 - lr * (step + weight_decay * p32))


def apply_adamw(params: Tree, grads: Tree, opt_state: Tree, *, lr: float,
                b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0) -> Tuple[Tree, Tree]:
    """One AdamW application on an ``adamw_init`` state: increments
    ``count``, then updates params and moments in place. Returns
    (params, state)."""
    count = opt_state["count"] + 1
    _adamw_update(params, grads, opt_state["mu"], opt_state["nu"], count,
                  lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay)
    return params, {"mu": opt_state["mu"], "nu": opt_state["nu"],
                    "count": count}


def adamw_init(params: Tree) -> Tree:
    """Zero f32 moments shaped like each parameter, and count 0 (int32)."""
    zeros = lambda t: torch.zeros(t.shape, dtype=torch.float32,  # noqa: E731
                                  device=t.device)
    dev = tree_leaves(params)[0].device
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def adamw_train_step(params: Tree, opt_state: Tree, tokens: torch.Tensor,
                     cfg, *, lr: float = 1e-3, b1: float = 0.9,
                     b2: float = 0.999, eps: float = 1e-8,
                     weight_decay: float = 0.0,
                     loss_fn: Callable = xent_loss, **loss_kw):
    """One single-device AdamW step: (params, state, loss); ``loss_fn``
    and ``loss_kw`` as in ``sgd_train_step``."""
    loss, grads = value_and_grad(loss_fn, params, tokens[:, :-1],
                                 tokens[:, 1:], cfg, **loss_kw)
    params, state = apply_adamw(params, grads, opt_state, lr=lr, b1=b1,
                                b2=b2, eps=eps, weight_decay=weight_decay)
    return params, state, loss


def shard_batch(tokens: torch.Tensor, mesh) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    """This rank's (inputs, targets) of a global batch tokens [B, S+1]:
    the next-token shift first, then rows over ``dp`` and columns over
    ``sp`` (the reference's ``P("dp", "sp")``); with an fsdp axis, rows
    over (dp, fsdp) jointly (``P(("dp", "fsdp"), "sp")``)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    dp = axis_size(mesh, "dp") * axis_size(mesh, "fsdp")
    sp = axis_size(mesh, "sp")
    if B % dp or S % sp:
        raise ValueError(f"batch [{B}, {S}] does not shard over dp={dp}, "
                         f"sp={sp}")
    i = axis_rank(mesh, "dp") * axis_size(mesh, "fsdp") + axis_rank(
        mesh, "fsdp")
    j = axis_rank(mesh, "sp")
    rows = slice(i * B // dp, (i + 1) * B // dp)
    cols = slice(j * S // sp, (j + 1) * S // sp)
    return inputs[rows, cols].contiguous(), targets[rows, cols].contiguous()


def opt_state_specs(specs: Tree) -> Tree:
    """The spec tree of an ``adamw_init`` state for params placed by
    ``specs`` (reference ``training.py:490``): the moments shard like
    their params, the count is replicated."""
    return {"mu": specs, "nu": specs, "count": P()}


def _whole_leaf(t: torch.Tensor, spec, sizes, mesh) -> torch.Tensor:
    """One leaf whole from every rank's slice (no gradient): all-gathered
    over every axis its spec splits it over, innermost first. Every rank
    of the mesh must call it; every rank gets the whole leaf."""
    t = t.detach()
    for d in reversed(range(len(spec))):
        entry = spec[d]
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for ax in reversed(axes):
            if sizes.get(ax, 1) == 1:
                continue
            parts = [torch.empty_like(t) for _ in range(sizes[ax])]
            dist.all_gather(parts, t.contiguous(),
                            group=axis_group(mesh, ax))
            t = torch.cat(parts, dim=d)
            del parts
    return t


def _whole_shape(t: torch.Tensor, spec, sizes) -> Tuple[int, ...]:
    shape = list(t.shape)
    for d, entry in enumerate(spec or ()):
        axes = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for ax in axes:
            shape[d] *= sizes.get(ax, 1)
    return tuple(shape)


def tp_gather(local: Tree, specs: Tree, mesh) -> Tree:
    """The whole tree from every rank's slices (no gradient): each leaf
    all-gathered over every axis its spec splits it over, innermost
    first — the counterpart of ``fsdp_gather_flat``, for tests and
    ``SpmdStep.gather``. Every rank of the mesh must call it; every rank
    gets the whole tree (a checkpoint gathers a leaf at a time instead:
    ``save_sharded``)."""
    sizes, _ = mesh_layout(mesh)
    return walk_specs(local, specs, lambda t, spec: (
        _whole_leaf(t, spec, sizes, mesh)
        if any(sizes.get(ax, 1) > 1 for ax in spec_axes(spec))
        else t.detach().clone()))


def save_sharded(path: str, params: Tree, opt_state: Tree, step: int, *,
                 specs: Tree, mesh) -> int:
    """``trainer.fit``'s checkpoint of a state sharded by ``specs`` (and
    ``opt_state_specs``) on ``mesh``: the file of the whole leaves, the
    one the reference's save of its global arrays writes. Collective:
    every rank calls it. One leaf at a time is gathered (over the axes
    that split it) and written by rank 0, then dropped, so no rank holds
    more than one whole leaf beside its slices; the ranks other than 0
    take part in each gather and drop its result. Every rank returns
    once the file is in place."""
    sizes, _ = mesh_layout(mesh)
    tree = {"params": params, "opt_state": opt_state,
            "step": torch.tensor(step, dtype=torch.int32)}
    tspecs = {"params": specs, "step": P(),
              "opt_state": opt_state_specs(specs) if opt_state else opt_state}

    def pending(t, spec):
        if not any(sizes.get(ax, 1) > 1 for ax in spec_axes(spec)):
            return t
        return checkpoint.Pending(_whole_shape(t, spec, sizes), t.dtype,
                                  functools.partial(_whole_leaf, t, spec,
                                                    sizes, mesh))
    tree = walk_specs(tree, tspecs, pending)
    n = 0
    if dist.get_rank() == 0:
        n = checkpoint.save(path, tree)
    else:
        # The gathers rank 0's write makes, in its (key) order.
        for _, leaf in checkpoint.key_paths(tree):
            if isinstance(leaf, checkpoint.Pending):
                leaf.make()
    dist.barrier()
    return n


def sharded_load(specs: Tree, mesh) -> Dict[str, Any]:
    """``trainer.load_state(shardings=)`` for this rank of ``mesh``: its
    slices of the params and AdamW state of a checkpoint saved whole."""
    return {"params": checkpoint.mesh_shardings(specs, mesh),
            "opt_state": checkpoint.mesh_shardings(opt_state_specs(specs),
                                                   mesh)}


def replicated_digest(tree: Tree, specs: Tree) -> str:
    """A hash of the leaves ``specs`` replicates (their bytes, in
    ``tree_leaves`` order): equal on two ranks exactly when those leaves
    are bit-equal there."""
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    flags = walk_specs(tree, specs, lambda t, spec: not spec_axes(spec))
    for t, rep in zip(tree_leaves(tree), tree_leaves(flags)):
        if rep:
            h.update(t.detach().contiguous().view(torch.uint8)
                     .reshape(-1).cpu().numpy().tobytes())
    return h.hexdigest()


def _mesh_mean(grads: Tree, loss: torch.Tensor, mesh, specs: Tree,
               axes) -> torch.Tensor:
    """Average the gradients and the loss over the data axes ``axes``:
    each leaf's gradient summed (in place) over those of its axes its
    spec does not split it over (a leaf split over ep under a2a already
    holds every ep rank's tokens' part, carried by the exchange), all
    divided by the product of their sizes. Returns the global mean
    loss."""
    n = 1
    for ax in axes:
        n *= axis_size(mesh, ax)
    live = [ax for ax in axes if axis_size(mesh, ax) > 1]

    def reduce(g, spec):
        split = spec_axes(spec)
        for ax in live:
            if ax not in split:
                dist.all_reduce(g, group=axis_group(mesh, ax))
        return g.div_(n)
    walk_specs(grads, specs, reduce)
    loss = loss.clone()
    for ax in live:
        dist.all_reduce(loss, group=axis_group(mesh, ax))
    return loss / n


def _spmd_ctx(mesh, sp_impl: str) -> ParallelCtx:
    """The SPMD steps' checks (reference ``training.py:116-126``) and
    their ParallelCtx: ring (or Ulysses) attention over sp, the Megatron
    operators over tp."""
    if sp_impl not in ("ring", "a2a"):
        raise ValueError(f"unknown sp_impl {sp_impl!r}; 'ring' or 'a2a'")
    if axis_size(mesh, "fsdp") > 1:
        raise NotImplementedError(
            "use make_fsdp_train_step for the manual-fsdp schedule, or "
            "pjit auto sharding with param_specs(fsdp='fsdp')")
    _reject_axes(mesh, ("pp", "ep"))
    return ParallelCtx(tp=axis_group(mesh, "tp"), sp=axis_group(mesh, "sp"),
                       sp_impl=sp_impl)


class SpmdStep:
    """One SPMD training step over ``mesh``: every rank passes the same
    global tokens [B, S+1]; ``shard_fn(tokens, mesh)`` gives this rank's
    (inputs, targets); ``loss_fn(params, inputs, targets, cfg, pctx=,
    **loss_kw)`` is this rank's local mean, differentiated with respect
    to this rank's slices (``specs`` on the mesh), its gradients and
    value averaged over the data axes ``axes``. SGD steps are called
    step(params, tokens) -> (params, loss); AdamW steps step(params,
    opt_state, tokens) -> (params, opt_state, loss), updating in
    place."""

    def __init__(self, cfg, mesh, *, lr, pctx, specs, axes, loss_fn,
                 shard_fn, loss_kw, adamw=False, weight_decay=0.0):
        self.cfg, self.mesh, self.lr, self.pctx = cfg, mesh, lr, pctx
        self.specs, self.axes = specs, tuple(axes)
        self.loss_fn, self.shard_fn, self.loss_kw = loss_fn, shard_fn, loss_kw
        self.adamw, self.weight_decay = adamw, weight_decay

    def loss_and_grads(self, params: Tree, tokens: torch.Tensor
                       ) -> Tuple[torch.Tensor, Tree]:
        """(global mean loss, this rank's averaged gradient slices)."""
        inputs, targets = self.shard_fn(tokens, self.mesh)
        loss, grads = value_and_grad(self.loss_fn, params, inputs, targets,
                                     self.cfg, pctx=self.pctx,
                                     **self.loss_kw)
        loss = _mesh_mean(grads, loss, self.mesh, self.specs, self.axes)
        return loss, grads

    def __call__(self, params, *rest):
        if not self.adamw:
            (tokens,) = rest
            loss, grads = self.loss_and_grads(params, tokens)
            return _sgd_update(params, grads, self.lr), loss
        opt_state, tokens = rest
        loss, grads = self.loss_and_grads(params, tokens)
        params, state = apply_adamw(params, grads, opt_state, lr=self.lr,
                                    weight_decay=self.weight_decay)
        return params, state, loss

    def shard(self, params: Tree, device=None) -> Tree:
        """This rank's slices of whole params."""
        return shard_tree(params, self.specs, self.mesh, device)

    def gather(self, params: Tree) -> Tree:
        """Whole params from the ranks' slices (collective)."""
        return tp_gather(params, self.specs, self.mesh)

    def save_state(self, path: str, params: Tree, opt_state: Tree,
                   step: int) -> int:
        """``trainer.fit``'s checkpoint of this step's state
        (``save_sharded``)."""
        return save_sharded(path, params, opt_state, step,
                            specs=self.specs, mesh=self.mesh)

    def load_shardings(self) -> Dict[str, Any]:
        """``trainer.load_state(shardings=)`` for this rank
        (``sharded_load``)."""
        return sharded_load(self.specs, self.mesh)


def make_spmd_train_step(cfg, mesh, *, lr: float = 1e-3,
                         sp_impl: str = "ring", loss_fn: Callable = xent_loss,
                         shard_fn: Callable = shard_batch, **loss_kw):
    """The SGD step over a dp x sp x tp ``mesh`` (``parallel.mesh
    .make_mesh``; reference ``training.py:102``): rows over dp, the
    sequence over sp (ring attention, or Ulysses with ``sp_impl="a2a"``),
    the weights over tp by ``transformer.param_specs`` (each rank passes
    its slices, ``SpmdStep.shard``), gradients and loss averaged over dp
    and sp. Returns an ``SpmdStep``: step(params, tokens) -> (params,
    global mean loss), params updated in place."""
    return SpmdStep(cfg, mesh, lr=lr, pctx=_spmd_ctx(mesh, sp_impl),
                    specs=param_specs(cfg), axes=data_axes(),
                    loss_fn=loss_fn, shard_fn=shard_fn, loss_kw=loss_kw)


def make_adamw_spmd_train_step(cfg, mesh, *, lr: float = 1e-3,
                               weight_decay: float = 0.0,
                               sp_impl: str = "ring",
                               loss_fn: Callable = xent_loss,
                               shard_fn: Callable = shard_batch, **loss_kw):
    """AdamW over ``mesh``, laid out as ``make_spmd_train_step`` (reference
    ``training.py:510``); the moments shard like the params
    (``opt_state_specs``: ``adamw_init`` of a rank's slices is its
    state). Returns an ``SpmdStep``: step(params, opt_state, tokens) ->
    (params, state, global mean loss)."""
    return SpmdStep(cfg, mesh, lr=lr, pctx=_spmd_ctx(mesh, sp_impl),
                    specs=param_specs(cfg), axes=data_axes(),
                    loss_fn=loss_fn, shard_fn=shard_fn, loss_kw=loss_kw,
                    adamw=True, weight_decay=weight_decay)




# --- manual fsdp (ZeRO-style sharded storage) -------------------------------
# Reference training.py:146-441. Each leaf is stored flat and zero-padded
# to a multiple of F (the fsdp size): globally [F, c] (the plain layout)
# or, for the streaming step, [F*c] with the layer stacks [L, F*c]; each
# rank holds only its own slice of every flat leaf ([1, c], [c] or
# [L, c]). ``_FsdpGather`` is FSDP's collective pair: the forward
# all-gathers the slices over the fsdp group, the backward
# reduce-scatters (sums) the gradient back to its owners, JAX's
# transpose of the tiled all_gather.

def _pad_to(flat: torch.Tensor, n_shards: int) -> torch.Tensor:
    """Zero-pad the last dim of ``flat`` to a multiple of n_shards."""
    return torch.nn.functional.pad(flat, (0, -flat.shape[-1] % n_shards))


def fsdp_shard_params(params: Tree, n_shards: int) -> Tree:
    """Every leaf flattened to [n_shards, ceil(size / n_shards)],
    zero-padded: the global storage of the manual fsdp step (reference
    ``training.py:148``)."""
    return tree_map(lambda p: _pad_to(p.reshape(-1), n_shards)
                    .reshape(n_shards, -1), params)


def _cut(f: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    n = like.numel()
    return f.reshape(-1)[:n].reshape(like.shape).to(like.dtype)


def fsdp_unshard_params(flat: Tree, like: Tree) -> Tree:
    """Inverse of ``fsdp_shard_params``; ``like`` gives shapes and dtypes
    (``init_params(..., device="meta")`` will do)."""
    if not isinstance(flat, dict):
        return _cut(flat, like)
    return {k: fsdp_unshard_params(v, like[k]) for k, v in flat.items()}


def fsdp_stream_shard_params(params: Tree, n_shards: int) -> Tree:
    """The streaming step's global storage (reference ``training.py:200``):
    leaves outside ``layers`` flatten to [F*c]; layer stacks keep their
    leading L and flatten per layer to [L, F*c], so the forward can
    gather one layer at a time. Zero-padded."""
    out = {}
    for k, v in params.items():
        if k == "layers":
            out[k] = tree_map(lambda p: _pad_to(p.reshape(p.shape[0], -1),
                                                n_shards), v)
        else:
            out[k] = tree_map(lambda p: _pad_to(p.reshape(-1), n_shards), v)
    return out


def fsdp_stream_unshard_params(flat: Tree, like: Tree) -> Tree:
    """Inverse of ``fsdp_stream_shard_params`` (checkpoint / eval
    export)."""
    out = {}
    for k, v in flat.items():
        if k == "layers":
            out[k] = {n: f[:, :like[k][n].numel() // f.shape[0]]
                      .reshape(like[k][n].shape).to(like[k][n].dtype)
                      for n, f in v.items()}
        else:
            out[k] = fsdp_unshard_params(v, like[k])
    return out


def fsdp_local(flat: Tree, n_shards: int, index: int, *,
               stream: bool) -> Tree:
    """Rank ``index``'s slices of a global flat tree, as tensors of their
    own: [1, c] of each [F, c] leaf (plain layout) or [c] / [L, c] of
    each [F*c] / [L, F*c] leaf (``stream``)."""
    def cut(f):
        if not stream:
            return f[index:index + 1].clone()
        c = f.shape[-1] // n_shards
        return f[..., index * c:(index + 1) * c].clone()
    return tree_map(cut, flat)


class _FsdpGather(torch.autograd.Function):
    """all_gather_into_tensor of each rank's slice along dim 0 over the
    fsdp group; the backward reduce-scatters (sums) the gradient so each
    rank gets its own slice's total."""

    @staticmethod
    def forward(ctx, shard, group):
        ctx.group = group
        n = dist.get_world_size(group)
        out = shard.new_empty((n * shard.shape[0],) + shard.shape[1:])
        dist.all_gather_into_tensor(out, shard.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        n = dist.get_world_size(ctx.group)
        out = g.new_empty((g.shape[0] // n,) + g.shape[1:])
        dist.reduce_scatter_tensor(out, g.contiguous(), group=ctx.group)
        return out, None


def fsdp_gather(shard: torch.Tensor, group) -> torch.Tensor:
    """The whole flat leaf from this rank's slice (differentiable);
    identity when ``group`` is None (fsdp size 1)."""
    return shard if group is None else _FsdpGather.apply(shard, group)


def fsdp_gather_flat(local: Tree, mesh, *, stream: bool) -> Tree:
    """The global flat tree from every rank's slices (no gradient): what
    a checkpoint of fsdp state holds. Every rank of the fsdp group must
    call it."""
    group = axis_group(mesh, "fsdp")
    if group is None:
        return tree_map(lambda t: t.detach().clone(), local)
    F = dist.get_world_size(group)

    def gather(t, layer):
        t = t.detach().contiguous()
        out = t.new_empty((F * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        if stream and layer:                   # [F*L, c] -> [L, F*c]
            return out.reshape(F, *t.shape).permute(1, 0, 2).reshape(
                t.shape[0], -1)
        return out
    return {k: tree_map(lambda t: gather(t, k == "layers"), v)
            for k, v in local.items()}


def fsdp_shardings(like: Tree, n_shards: int, index: int, *,
                   stream: bool) -> Tree:
    """The ``checkpoint.restore(shardings=)`` tree that reads a global
    flat fsdp checkpoint (either layout, written at any fsdp size) as
    rank ``index``'s slices at ``n_shards``. ``like`` is the unsharded
    params tree (shapes only: ``init_params(..., device="meta")``)."""
    def spec(p, layer):
        if layer and stream:
            return FlatShard(p.numel() // p.shape[0], n_shards, index,
                             rows=p.shape[0])
        return FlatShard(p.numel(), n_shards, index, stacked=not stream)
    return {k: tree_map(lambda p: spec(p, k == "layers"), v)
            for k, v in like.items()}


def _reject_axes(mesh, axes) -> None:
    for ax in axes:
        if axis_size(mesh, ax) > 1:
            raise NotImplementedError(
                f"{ax} axis not used by the dense-LM train step "
                f"(pp: models.pipeline; ep: models.moe)")


def _fsdp_setup(cfg: TransformerConfig, mesh, *, stream: bool):
    """Shared validation and layout of the fsdp factories (reference
    ``_fsdp_stream_setup``, ``training.py:286``): (like, F, group,
    index, pctx)."""
    if stream and not cfg.remat:
        raise ValueError(
            "streaming fsdp requires cfg.remat=True: without "
            "checkpointing the block the backward saves all gathered "
            "layers and the one-layer peak-memory property is lost "
            "(use make_fsdp_train_step)")
    if axis_size(mesh, "tp") > 1:
        raise NotImplementedError(
            "manual fsdp with tp: use pjit auto sharding with "
            "param_specs(tp='tp', fsdp='fsdp')")
    _reject_axes(mesh, ("pp", "ep"))
    like = init_params(0, cfg, device="meta")
    return (like, axis_size(mesh, "fsdp"), axis_group(mesh, "fsdp"),
            axis_rank(mesh, "fsdp"), ParallelCtx(sp=mesh.get_group("sp")))


def _global_value_and_grad(loss_fn: Callable, flat: Tree, mesh
                           ) -> Tuple[torch.Tensor, Tree]:
    """(global mean loss, this rank's gradient slices) of ``loss_fn(flat)``
    (this rank's local mean): the local loss carries the global mean's
    1/n before the backward, whose fsdp gathers reduce-scatter; the
    slices are then summed over dp and sp, the ranks that hold the same
    slices."""
    n = mesh.size()
    leaves = [t.detach().requires_grad_() for t in tree_leaves(flat)]
    loss = loss_fn(_unflatten(flat, leaves))
    grads = torch.autograd.grad(loss / n, leaves)
    for ax in ("dp", "sp"):
        if axis_size(mesh, ax) > 1:
            for g in grads:
                dist.all_reduce(g, group=axis_group(mesh, ax))
    loss = loss.detach().clone()
    dist.all_reduce(loss)
    return loss / n, _unflatten(flat, list(grads))


def make_fsdp_train_step(cfg: TransformerConfig, mesh, *,
                         lr: float = 1e-3):
    """Manual fsdp SGD step over fsdp x dp x sp (reference
    ``training.py:400``). Params live sharded (``fsdp_shard_params``:
    each rank holds [1, c] of every [F, c] leaf); each step gathers the
    whole tree, takes the loss global over (dp, fsdp, sp) and lets the
    gathers' backward reduce-scatter the gradient. Tokens [B, S+1]
    shard rows over (dp, fsdp) jointly and the sequence over sp (ring
    attention). Returns (step, shard_fn): step(flat, tokens) -> (flat,
    global mean loss), updating this rank's slices in place;
    shard_fn(params) -> this rank's slices."""
    like, F, group, index, pctx = _fsdp_setup(cfg, mesh, stream=False)

    def loss_fn(flat, inputs, targets):
        full = tree_map(lambda f: fsdp_gather(f, group), flat)
        return xent_loss(fsdp_unshard_params(full, like), inputs, targets,
                         cfg, pctx=pctx)

    def step(flat, tokens):
        inputs, targets = shard_batch(tokens, mesh)
        loss, grads = _global_value_and_grad(
            lambda f: loss_fn(f, inputs, targets), flat, mesh)
        return _sgd_update(flat, grads, lr), loss

    def shard_fn(params):
        return fsdp_local(fsdp_shard_params(params, F), F, index,
                          stream=False)

    return step, shard_fn


def _fsdp_stream_loss(flat, inputs, targets, *, like, cfg, group, pctx):
    """Streaming-fsdp local loss (reference ``training.py:236``): the
    small leaves gathered up front, each layer's slices gathered inside
    its (checkpointed) block through ``forward``'s ``layers_hook``, so
    at most one layer is whole at a time; under remat the backward
    gathers each layer again and reduce-scatters its gradient."""
    layer_like = {n: p[0] for n, p in like["layers"].items()}

    def hook(layer_flat):
        return {n: _cut(fsdp_gather(f, group), layer_like[n])
                for n, f in layer_flat.items()}

    params = {k: fsdp_unshard_params(tree_map(
        lambda f: fsdp_gather(f, group), v), like[k])
        for k, v in flat.items() if k != "layers"}
    params["layers"] = flat["layers"]            # consumed through the hook
    return xent_loss(params, inputs, targets, cfg, pctx=pctx,
                     layers_hook=hook)


def make_fsdp_stream_train_step(cfg: TransformerConfig, mesh, *,
                                lr: float = 1e-3):
    """The streaming-gather form of ``make_fsdp_train_step`` (reference
    ``training.py:314``; the same math): layer params are gathered one
    layer at a time inside the forward, so the transient whole-param
    memory is the small leaves plus one layer. Requires cfg.remat.
    Returns (step, shard_fn), storage ``fsdp_stream_shard_params``."""
    like, F, group, index, pctx = _fsdp_setup(cfg, mesh, stream=True)

    def step(flat, tokens):
        inputs, targets = shard_batch(tokens, mesh)
        loss, grads = _global_value_and_grad(
            lambda f: _fsdp_stream_loss(f, inputs, targets, like=like,
                                        cfg=cfg, group=group, pctx=pctx),
            flat, mesh)
        return _sgd_update(flat, grads, lr), loss

    def shard_fn(params):
        return fsdp_local(fsdp_stream_shard_params(params, F), F, index,
                          stream=True)

    return step, shard_fn


def make_fsdp_stream_adamw_step(cfg: TransformerConfig, mesh, *,
                                lr: float = 1e-3, weight_decay: float = 0.0):
    """AdamW on the streaming-fsdp layout (reference ``training.py:342``):
    params, gradients and the f32 moments all 1/F per rank, the moments
    on the same flat slices as the params (AdamW is elementwise, so the
    update is wholly rank-local; padding keeps zero gradients and zero
    moments). Returns (step, shard_fn, opt_init): step(flat, opt_state,
    tokens) -> (flat, opt_state, loss); opt_init(flat) -> the zero state
    on this rank's slices."""
    like, F, group, index, pctx = _fsdp_setup(cfg, mesh, stream=True)

    def step(flat, opt_state, tokens):
        inputs, targets = shard_batch(tokens, mesh)
        loss, grads = _global_value_and_grad(
            lambda f: _fsdp_stream_loss(f, inputs, targets, like=like,
                                        cfg=cfg, group=group, pctx=pctx),
            flat, mesh)
        flat, state = apply_adamw(flat, grads, opt_state, lr=lr,
                                  weight_decay=weight_decay)
        return flat, state, loss

    def shard_fn(params):
        return fsdp_local(fsdp_stream_shard_params(params, F), F, index,
                          stream=True)

    return step, shard_fn, adamw_init
