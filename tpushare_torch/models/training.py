"""Training steps for the transformer LM. Counterpart of
``tpushare/models/training.py``.

One loss (``xent_loss``), one gradient routine (``value_and_grad``) and
two update rules (SGD, AdamW), run two ways: single device
(``sgd_train_step``, ``adamw_train_step``) and SPMD over a ``("dp",
"sp")`` mesh (``make_spmd_train_step``, ``make_adamw_spmd_train_step``:
batch rows over dp, sequence over sp through ring attention, or Ulysses
all-to-all attention with ``sp_impl="a2a"``). The four steps take the
loss (``loss_fn``) and, under SPMD, the sharding (``shard_fn``) as
parameters; ``moe.py``'s steps are these with its own loss and
``moe.shard_pairs``.

Gradients under SPMD: the reference makes the loss global (pmean over
the data axes) before ``jax.grad`` and lets the shard_map transpose
insert the reductions (``training.py:10-16``). The port takes each
rank's local mean and backwards it — the ring backward returns every
K/V chunk's gradient to the rank that owns it — then all-reduces (sum)
the gradients over the mesh and divides by its size: the gradient of
the same global mean, since the shards are equal. The next-token shift
happens before sharding (``:110-114``), so every shard holds aligned
(input, target) pairs.

Updates use f32 math and keep each parameter's dtype (``:65-71``,
``:456-463``); AdamW increments ``count`` before its update. Unlike the
reference, which returns new arrays, the port updates parameters and
AdamW moments IN PLACE (a full-width model holds its parameters once)
and returns the same dicts. Trees are the nested dicts of
``transformer.init_params``; leaves are walked in sorted-key order, the
same on every rank.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from tpushare_torch.models.transformer import (
    ParallelCtx, TransformerConfig, forward,
)

TODO_FSDP = "ROADMAP A12 (fsdp training steps)"

Tree = Dict[str, Any]


def tree_leaves(tree: Tree) -> List[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order."""
    out = []
    for key in sorted(tree):
        val = tree[key]
        out.extend(tree_leaves(val) if isinstance(val, dict) else [val])
    return out


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """A nested dict of the same keys with ``fn`` applied to each tensor."""
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


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
    ``sp`` (the reference's ``P("dp", "sp")``)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    B, S = inputs.shape
    dp, sp = mesh["dp"].size(), mesh["sp"].size()
    if B % dp or S % sp:
        raise ValueError(f"batch [{B}, {S}] does not shard over dp={dp}, "
                         f"sp={sp}")
    i, j = mesh.get_local_rank("dp"), mesh.get_local_rank("sp")
    rows = slice(i * B // dp, (i + 1) * B // dp)
    cols = slice(j * S // sp, (j + 1) * S // sp)
    return inputs[rows, cols].contiguous(), targets[rows, cols].contiguous()


def _mesh_mean(grads: Tree, loss: torch.Tensor, mesh) -> torch.Tensor:
    """Sum gradients and the loss over the mesh (which spans the default
    process group), divide by its size; the gradients in place. Returns
    the global mean loss."""
    n = mesh.size()
    for g in tree_leaves(grads):
        dist.all_reduce(g)
        g.div_(n)
    loss = loss.clone()
    dist.all_reduce(loss)
    return loss / n


def _spmd_ctx(mesh, sp_impl: str) -> ParallelCtx:
    if sp_impl not in ("ring", "a2a"):
        raise ValueError(f"unknown sp_impl {sp_impl!r}; 'ring' or 'a2a'")
    return ParallelCtx(sp=mesh.get_group("sp"), sp_impl=sp_impl)


def make_spmd_train_step(cfg, mesh, *, lr: float = 1e-3,
                         sp_impl: str = "ring", loss_fn: Callable = xent_loss,
                         shard_fn: Callable = shard_batch, **loss_kw):
    """The SGD step over ``mesh`` (``parallel.mesh.make_mesh``): every
    rank passes the same global tokens [B, S+1]; ``shard_fn(tokens,
    mesh)`` gives this rank's (inputs, targets) (rows over dp, the
    sequence over sp), attention runs as ring attention over sp (or
    Ulysses with ``sp_impl="a2a"``), and ``loss_fn(params, inputs,
    targets, cfg, pctx=, **loss_kw)``'s gradients and value are
    averaged over the mesh. Returns step(params, tokens) -> (params,
    global mean loss); params are replicated and stay equal on every
    rank."""
    pctx = _spmd_ctx(mesh, sp_impl)

    def step(params, tokens):
        inputs, targets = shard_fn(tokens, mesh)
        loss, grads = value_and_grad(loss_fn, params, inputs, targets, cfg,
                                     pctx=pctx, **loss_kw)
        loss = _mesh_mean(grads, loss, mesh)
        return _sgd_update(params, grads, lr), loss

    return step


def make_adamw_spmd_train_step(cfg, mesh, *, lr: float = 1e-3,
                               weight_decay: float = 0.0,
                               sp_impl: str = "ring",
                               loss_fn: Callable = xent_loss,
                               shard_fn: Callable = shard_batch, **loss_kw):
    """AdamW over ``mesh``, laid out as ``make_spmd_train_step``; the
    moments are replicated like the params. Returns step(params,
    opt_state, tokens) -> (params, state, global mean loss)."""
    pctx = _spmd_ctx(mesh, sp_impl)

    def step(params, opt_state, tokens):
        inputs, targets = shard_fn(tokens, mesh)
        loss, grads = value_and_grad(loss_fn, params, inputs, targets, cfg,
                                     pctx=pctx, **loss_kw)
        loss = _mesh_mean(grads, loss, mesh)
        params, state = apply_adamw(params, grads, opt_state, lr=lr,
                                    weight_decay=weight_decay)
        return params, state, loss

    return step


def make_fsdp_train_step(cfg: TransformerConfig, mesh, **_):
    """Manual-fsdp step (reference ``training.py:400``): not ported."""
    raise NotImplementedError(f"make_fsdp_train_step: {TODO_FSDP}")


def make_fsdp_stream_train_step(cfg: TransformerConfig, mesh, **_):
    """Streaming-fsdp SGD step (reference ``training.py:314``): not
    ported."""
    raise NotImplementedError(f"make_fsdp_stream_train_step: {TODO_FSDP}")


def make_fsdp_stream_adamw_step(cfg: TransformerConfig, mesh, **_):
    """Streaming-fsdp AdamW step (reference ``training.py:342``): not
    ported."""
    raise NotImplementedError(f"make_fsdp_stream_adamw_step: {TODO_FSDP}")
