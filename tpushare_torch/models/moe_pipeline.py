"""Pipeline parallelism for the MoE LM. Counterpart of
``tpushare/models/moe_pipeline.py``.

The stacked MoE layers split over ``pp`` as the dense pipeline's do
(``pipeline.stage_params``: contiguous blocks per stage, the embedding,
final norm and head replicated), and run the GPipe schedule: the
M + P - 1 round fill/drain loop, differentiated by autograd, one
``pipeline._Hop`` per round. Inside a stage the FFN is
``moe._moe_ffn``, unchanged; its aux statistics average over dp.

Over pp x ep x tp x dp (reference ``:179-242``): each rank holds its
stage's layers, their experts split over ep and the expert hidden and
attention over tp (``param_specs``); the block's attention runs the
Megatron operators over tp and ``moe._moe_ffn`` its ep / tp training
dispatch (the microbatches replicated over ep). Routing: ``"psum"`` and
``"dropless"`` ride the pipeline; ``"a2a"`` is refused as the reference
refuses it (it makes ep a data axis, which contradicts the replicated
microbatch queue).

The aux (load-balancing) loss counts only rounds that carry a real
microbatch: every stage accumulates its per-round mean aux over its
valid rounds, and the sum over pp divided by P*M is the mean over
layers and microbatches (reference docstring ``:21-30``). The aux is
nonlinear in the batch, so the objective is the mean of the
per-microbatch losses, the standard microbatched-MoE objective.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from tpushare_torch.models.moe import MoEConfig, _moe_ffn
from tpushare_torch.models.moe import param_specs as moe_specs
from tpushare_torch.models.pipeline import (_Hop, _pick, checkpointed,
                                            gpipe_grads)
from tpushare_torch.models.training import _sgd_update, apply_adamw
from tpushare_torch.models.transformer import copy_to, tp_matmul
from tpushare_torch.ops.attention import attention
from tpushare_torch.ops.norms import rms_norm
from tpushare_torch.ops.rotary import apply_rotary, rotary_embedding
from tpushare_torch.parallel.mesh import axis_group, axis_rank, axis_size
from tpushare_torch.parallel.sharding import P


def param_specs(cfg: MoEConfig, *, pp: str = "pp", tp: str = "tp",
                ep: str = "ep") -> Dict[str, Any]:
    """The MoE specs with the stacked-layer axis split over pp
    (reference ``moe_pipeline.py:54``): experts stay over ep, the expert
    hidden over tp."""
    specs = moe_specs(cfg, tp=tp, ep=ep)
    specs["layers"] = {k: P(pp, *tuple(s)[1:])
                       for k, s in specs["layers"].items()}
    return specs


def _block(x, layer: Dict[str, torch.Tensor], cfg: MoEConfig, cos, sin,
           data_groups, attn_impl: str, tp=None, ep=None):
    """One MoE block without a cache: (x, this layer's aux)."""
    B, S, _ = x.shape
    Dh = cfg.head_dim
    h = copy_to(rms_norm(x, layer["ln1"], eps=cfg.norm_eps), tp)
    H = layer["wq"].shape[-1] // Dh
    Hkv = layer["wk"].shape[-1] // Dh
    q = apply_rotary((h @ layer["wq"]).reshape(B, S, H, Dh), cos, sin)
    k = apply_rotary((h @ layer["wk"]).reshape(B, S, Hkv, Dh), cos, sin)
    v = (h @ layer["wv"]).reshape(B, S, Hkv, Dh)
    attn = attention(q, k, v, causal=True, impl=attn_impl)
    x = x + tp_matmul(attn.reshape(B, S, H * Dh), layer["wo"], tp)
    h = rms_norm(x, layer["ln2"], eps=cfg.norm_eps)
    ff, aux = _moe_ffn(h, layer, cfg, data_axes=data_groups, tp=tp, ep=ep)
    return x + ff, aux


def moe_pipelined_lm_loss(params, inputs: torch.Tensor,
                          targets: torch.Tensor, cfg: MoEConfig, *,
                          pp_group, data_groups=(), n_microbatches: int,
                          attn_impl: str = "auto", tp_group=None,
                          ep_group=None) -> torch.Tensor:
    """This rank's term of the MoE loss (nll + aux_loss_weight * aux)
    through the pp pipeline (reference ``moe_pipeline.py:64``);
    inputs/targets [B, S] aligned (this rank's dp rows), ``params`` this
    stage's. The last stage's term holds the mean nll; every stage's
    holds aux_loss_weight times its valid rounds' aux / (P*M). Summed
    over pp it is the loss; every rank backwards its own term."""
    if cfg.routing == "a2a":
        raise NotImplementedError(
            "routing='a2a' shards tokens over ep (ep as a data axis) "
            "and cannot ride the pipeline's replicated microbatches; "
            "use routing='psum' or 'dropless' with pp")
    P = 1 if pp_group is None else dist.get_world_size(pp_group)
    s = 0 if pp_group is None else dist.get_rank(pp_group)
    M = n_microbatches
    B, S = inputs.shape
    if B % M:
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    Bm = B // M
    positions = torch.arange(S, device=inputs.device)[None, :].expand(Bm, S)
    cos, sin = rotary_embedding(positions, cfg.head_dim, base=cfg.rope_base,
                                scaling=cfg.rope_scaling)
    x_mb = params["embed"][inputs.reshape(M, Bm, S).long()].to(cfg.dtype)
    layers = params["layers"]
    n_local = next(iter(layers.values())).shape[0]
    remat = cfg.remat and torch.is_grad_enabled()

    def local_layers(x):
        auxes = []
        for li in range(n_local):
            layer = {k: a[li] for k, a in layers.items()}
            if remat:
                x, aux = checkpoint(_block, x, layer, cfg, cos, sin,
                                    data_groups, attn_impl, tp_group,
                                    ep_group, use_reentrant=False,
                                    preserve_rng_state=False)
            else:
                x, aux = _block(x, layer, cfg, cos, sin, data_groups,
                                attn_impl, tp_group, ep_group)
            auxes.append(aux)
        return x, torch.stack(auxes).mean()

    inflight = torch.zeros((Bm, S, cfg.d_model), dtype=cfg.dtype,
                           device=inputs.device)
    outs, aux_terms = [], []
    T = M + P - 1
    for t in range(T):
        inp = _pick(s == 0, x_mb[min(t, M - 1)], inflight)
        act, aux = local_layers(inp)
        # Only rounds carrying a real microbatch feed the router loss.
        if 0 <= t - s < M:
            aux_terms.append(aux)
        if t >= P - 1:
            outs.append(act)
        if t < T - 1:
            inflight = _Hop.apply(act, pp_group, s, P)
    term = cfg.aux_loss_weight * torch.stack(aux_terms).sum() / (P * M)
    y = torch.stack(outs).reshape(B, S, cfg.d_model)
    if s != P - 1:
        return term + y.sum() * 0.0
    x = rms_norm(y, params["final_norm"], eps=cfg.norm_eps)
    unembed = (params["embed"].T if cfg.tie_embeddings
               else params["unembed"]).to(cfg.dtype)
    logp = torch.log_softmax((x @ unembed).float(), dim=-1)
    nll = -torch.gather(logp, -1, targets.long()[..., None]).mean()
    return nll + term


def _check_mesh(cfg: MoEConfig, mesh) -> None:
    """The reference's check (``:179``), and the axes it does not
    compose with the MoE pipeline."""
    if cfg.n_experts % axis_size(mesh, "ep"):
        raise ValueError(f"ep={axis_size(mesh, 'ep')} must divide "
                         f"n_experts={cfg.n_experts}")
    for ax in ("sp", "fsdp"):
        if axis_size(mesh, ax) > 1:
            raise NotImplementedError(f"MoE pipeline with {ax} > 1: the "
                                      f"reference runs pp x ep x tp x dp")


def moe_pp_loss_and_grads(params, tokens: torch.Tensor, cfg: MoEConfig,
                          mesh, *, n_microbatches: int,
                          attn_impl: str = "auto"):
    """(global loss, grads of this stage's params) of tokens [B, S+1]:
    the shift first, rows over dp."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    dp = axis_size(mesh, "dp")
    if inputs.shape[0] % dp:
        raise ValueError(f"batch {inputs.shape[0]} does not shard over "
                         f"dp={dp}")
    i, n = axis_rank(mesh, "dp"), inputs.shape[0] // dp
    inputs = inputs[i * n:(i + 1) * n].contiguous()
    targets = targets[i * n:(i + 1) * n].contiguous()
    pp = axis_group(mesh, "pp")
    data = (mesh.get_group("dp"),) if dp > 1 else ()
    return gpipe_grads(lambda p: moe_pipelined_lm_loss(
        p, inputs, targets, cfg, pp_group=pp, data_groups=data,
        n_microbatches=n_microbatches, attn_impl=attn_impl,
        tp_group=axis_group(mesh, "tp"), ep_group=axis_group(mesh, "ep")),
        params, pp, data)


def make_moe_pp_train_step(cfg: MoEConfig, mesh, *, n_microbatches: int,
                           lr: float = 1e-3, attn_impl: str = "auto"):
    """SGD over a pp x ep x tp x dp mesh for the MoE LM (reference
    ``:193``): step(params, tokens [B, S+1]) -> (params, loss), params
    this rank's (``pipeline.stage_params``, or ``sharding.shard_tree``
    of ``param_specs`` under ep / tp), updated in place."""
    _check_mesh(cfg, mesh)

    def step(params, tokens):
        loss, grads = moe_pp_loss_and_grads(
            params, tokens, cfg, mesh, n_microbatches=n_microbatches,
            attn_impl=attn_impl)
        return _sgd_update(params, grads, lr), loss

    return checkpointed(step, param_specs(cfg), mesh)


def make_moe_pp_adamw_train_step(cfg: MoEConfig, mesh, *,
                                 n_microbatches: int, lr: float = 1e-3,
                                 weight_decay: float = 0.0,
                                 attn_impl: str = "auto"):
    """AdamW over the pp x ep x tp x dp mesh (reference ``:215``): f32
    moments of this rank's params only (``training.adamw_init`` of
    them).
    step(params, opt_state, tokens) -> (params, opt_state, loss)."""
    _check_mesh(cfg, mesh)

    def step(params: Dict[str, Any], opt_state, tokens):
        loss, grads = moe_pp_loss_and_grads(
            params, tokens, cfg, mesh, n_microbatches=n_microbatches,
            attn_impl=attn_impl)
        params, state = apply_adamw(params, grads, opt_state, lr=lr,
                                    weight_decay=weight_decay)
        return params, state, loss

    return checkpointed(step, param_specs(cfg), mesh)
