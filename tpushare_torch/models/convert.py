"""Hugging Face checkpoint conversion for the decoder LMs. Counterpart
of ``tpushare/models/convert.py``.

Configs: ``config_from_hf`` (Llama / Gemma / Gemma-2) and
``moe_config_from_hf`` (Mixtral) read fields by name from any object,
so a ``transformers`` config, a ``types.SimpleNamespace`` of a
published ``config.json`` or anything alike works. Weights:
``from_hf`` / ``moe_from_hf`` take a state dict (torch tensors or
numpy arrays) or an already-built ``*ForCausalLM`` model and return the
port's stacked-layer params on a device. Nothing is downloaded, and
``transformers`` is never imported here.

Layout: HF Linear weights are [out, in]; the port stores [in, out]
(``x @ w``); q/k/v out axes are head-major, as the reshape to
[..., H, Dh] expects; HF's rotate_half rotary is ``ops/rotary.py``'s
half split. Naming trap: Llama's ``post_attention_layernorm`` is the
pre-FFW norm (ln2); in Gemma-2 it is a norm on the attention output
(ln_post_attn) and ``pre_feedforward_layernorm`` is ln2. Mixtral: the
router ``block_sparse_moe.gate`` [E, Dm] becomes [Dm, E]; the experts'
``w1`` / ``w3`` / ``w2`` stack to [L, E, in, out].
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.models.moe import MoEConfig
from tpushare_torch.models.transformer import TransformerConfig


def _rope_scaling(hf_cfg):
    """HF rope_scaling dict -> the config tuple (llama3 scheme only;
    other rope types raise rather than serve wrong frequencies)."""
    rs = getattr(hf_cfg, "rope_scaling", None)
    if not rs:
        return None
    kind = rs.get("rope_type", rs.get("type", ""))
    if kind == "default":        # HF's explicit "no scaling" marker
        return None
    if kind != "llama3":
        raise NotImplementedError(f"rope_scaling type {kind!r}")
    return (float(rs["factor"]), float(rs["low_freq_factor"]),
            float(rs["high_freq_factor"]),
            float(rs["original_max_position_embeddings"]))


def config_from_hf(hf_cfg, dtype: torch.dtype = torch.bfloat16
                   ) -> TransformerConfig:
    """TransformerConfig from a Llama / Gemma / Gemma-2 style config."""
    model_type = getattr(hf_cfg, "model_type", "llama")
    is_gemma = "gemma" in model_type
    is_gemma2 = model_type == "gemma2"
    head_dim = getattr(hf_cfg, "head_dim", None) or (
        hf_cfg.hidden_size // hf_cfg.num_attention_heads)
    qk_scale = getattr(hf_cfg, "query_pre_attn_scalar", None)
    return TransformerConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads",
                           hf_cfg.num_attention_heads),
        head_dim=head_dim,
        d_ff=hf_cfg.intermediate_size,
        rope_base=getattr(hf_cfg, "rope_theta", 10_000.0),
        rope_scaling=_rope_scaling(hf_cfg),
        norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-6),
        norm_offset=1.0 if is_gemma else 0.0,
        act="gelu" if is_gemma else "silu",
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        embed_scale=is_gemma,
        attn_scale=(qk_scale ** -0.5 if is_gemma2 and qk_scale else None),
        sliding_window=(getattr(hf_cfg, "sliding_window", None)
                        if is_gemma2 else None),
        alternate_sliding=is_gemma2,
        attn_softcap=(getattr(hf_cfg, "attn_logit_softcapping", None)
                      if is_gemma2 else None),
        final_softcap=(getattr(hf_cfg, "final_logit_softcapping", None)
                       if is_gemma2 else None),
        post_norms=is_gemma2,
        dtype=dtype,
    )


def moe_config_from_hf(hf_cfg, dtype: torch.dtype = torch.bfloat16
                       ) -> MoEConfig:
    """MoEConfig from a Mixtral config. HF Mixtral softmaxes over all
    experts, takes the top-k and renormalizes the selected weights —
    the rule of ``moe._moe_ffn``. Routing is "psum" with dense dispatch;
    the head is untied unless the config ties it."""
    if getattr(hf_cfg, "model_type", "") != "mixtral":
        raise NotImplementedError(
            f"moe_config_from_hf expects a mixtral config, got "
            f"{getattr(hf_cfg, 'model_type', None)!r}")
    head_dim = getattr(hf_cfg, "head_dim", None) or (
        hf_cfg.hidden_size // hf_cfg.num_attention_heads)
    act = getattr(hf_cfg, "hidden_act", "silu")
    if act not in ("silu", "gelu"):
        raise NotImplementedError(f"mixtral hidden_act {act!r}")
    return MoEConfig(
        vocab_size=hf_cfg.vocab_size,
        d_model=hf_cfg.hidden_size,
        n_layers=hf_cfg.num_hidden_layers,
        n_heads=hf_cfg.num_attention_heads,
        n_kv_heads=getattr(hf_cfg, "num_key_value_heads",
                           hf_cfg.num_attention_heads),
        head_dim=head_dim,
        d_ff=hf_cfg.intermediate_size,
        n_experts=hf_cfg.num_local_experts,
        top_k=hf_cfg.num_experts_per_tok,
        rope_base=getattr(hf_cfg, "rope_theta", 10_000.0),
        rope_scaling=_rope_scaling(hf_cfg),
        norm_eps=getattr(hf_cfg, "rms_norm_eps", 1e-6),
        act=act,
        aux_loss_weight=getattr(hf_cfg, "router_aux_loss_coef", 0.01),
        tie_embeddings=bool(getattr(hf_cfg, "tie_word_embeddings", False)),
        dtype=dtype,
    )


def _source(model_or_state: Any, hf_cfg):
    """(state dict, HF config) of a model or a state dict."""
    if hasattr(model_or_state, "state_dict"):
        if hf_cfg is None:
            hf_cfg = model_or_state.config
        state = model_or_state.state_dict()
    else:
        state = dict(model_or_state)
    if hf_cfg is None:
        raise ValueError("hf_cfg required when passing a raw state dict")
    return state, hf_cfg


def _getter(state: Dict[str, Any], dtype: torch.dtype,
            dev: torch.device) -> Callable[..., torch.Tensor]:
    """get(name, transpose=False): the tensor under ``model.<name>`` or
    ``<name>``, through f32 (as the reference reads it) to ``dtype`` on
    ``dev``."""
    def get(name: str, transpose: bool = False) -> torch.Tensor:
        for prefix in ("model.", ""):
            if prefix + name in state:
                t = state[prefix + name]
                t = (t.detach() if isinstance(t, torch.Tensor)
                     else torch.from_numpy(np.asarray(t)))
                t = t.to(device=dev, dtype=torch.float32)
                return (t.T if transpose else t).to(dtype).contiguous()
        raise KeyError(f"{name} not found (have e.g. "
                       f"{sorted(state)[:4]}...)")
    return get


def from_hf(model_or_state: Any, hf_cfg=None,
            dtype: torch.dtype = torch.bfloat16, *,
            device: DeviceLike = None
            ) -> Tuple[Dict[str, Any], TransformerConfig]:
    """Convert a transformers Llama / Gemma / Gemma-2 ``*ForCausalLM``
    (or its state dict) to (params, TransformerConfig) on ``device``."""
    state, hf_cfg = _source(model_or_state, hf_cfg)
    cfg = config_from_hf(hf_cfg, dtype=dtype)
    get = _getter(state, dtype, resolve_device(device))
    L = cfg.n_layers

    def stack_linear(fmt: str) -> torch.Tensor:
        return torch.stack([get(fmt.format(i), True) for i in range(L)])

    def stack_norm(fmt: str) -> torch.Tensor:
        return torch.stack([get(fmt.format(i)) for i in range(L)])

    ln2_src = ("layers.{}.pre_feedforward_layernorm.weight"
               if cfg.post_norms
               else "layers.{}.post_attention_layernorm.weight")
    params: Dict[str, Any] = {
        "embed": get("embed_tokens.weight"),
        "layers": {
            "ln1": stack_norm("layers.{}.input_layernorm.weight"),
            "ln2": stack_norm(ln2_src),
            "wq": stack_linear("layers.{}.self_attn.q_proj.weight"),
            "wk": stack_linear("layers.{}.self_attn.k_proj.weight"),
            "wv": stack_linear("layers.{}.self_attn.v_proj.weight"),
            "wo": stack_linear("layers.{}.self_attn.o_proj.weight"),
            "w_gate": stack_linear("layers.{}.mlp.gate_proj.weight"),
            "w_up": stack_linear("layers.{}.mlp.up_proj.weight"),
            "w_down": stack_linear("layers.{}.mlp.down_proj.weight"),
        },
        "final_norm": get("norm.weight"),
    }
    if cfg.post_norms:
        params["layers"]["ln_post_attn"] = stack_norm(
            "layers.{}.post_attention_layernorm.weight")
        params["layers"]["ln_post_ffw"] = stack_norm(
            "layers.{}.post_feedforward_layernorm.weight")
    if not cfg.tie_embeddings:
        params["unembed"] = get("lm_head.weight", True)
    return params, cfg


def moe_from_hf(model_or_state: Any, hf_cfg=None,
                dtype: torch.dtype = torch.bfloat16, *,
                device: DeviceLike = None) -> Tuple[Dict[str, Any], MoEConfig]:
    """Convert a transformers MixtralForCausalLM (or its state dict) to
    (params, MoEConfig) on ``device``. A sliding window shorter than the
    context raises: ``moe.forward`` is full-causal. Expert stacks are
    built one layer at a time, so the f32 transient is one expert
    matrix."""
    state, hf_cfg = _source(model_or_state, hf_cfg)
    sw = getattr(hf_cfg, "sliding_window", None)
    if sw is not None and sw < hf_cfg.max_position_embeddings:
        raise NotImplementedError(
            f"mixtral sliding_window={sw} < max_position_embeddings="
            f"{hf_cfg.max_position_embeddings}: moe.forward is "
            f"full-causal")
    cfg = moe_config_from_hf(hf_cfg, dtype=dtype)
    get = _getter(state, dtype, resolve_device(device))
    L, E = cfg.n_layers, cfg.n_experts

    def stack_linear(fmt: str) -> torch.Tensor:
        return torch.stack([get(fmt.format(i), True) for i in range(L)])

    def stack_experts(w: str) -> torch.Tensor:
        return torch.stack([torch.stack([
            get(f"layers.{i}.block_sparse_moe.experts.{e}.{w}.weight", True)
            for e in range(E)]) for i in range(L)])

    params: Dict[str, Any] = {
        "embed": get("embed_tokens.weight"),
        "layers": {
            "ln1": torch.stack([get(f"layers.{i}.input_layernorm.weight")
                                for i in range(L)]),
            "ln2": torch.stack([
                get(f"layers.{i}.post_attention_layernorm.weight")
                for i in range(L)]),
            "wq": stack_linear("layers.{}.self_attn.q_proj.weight"),
            "wk": stack_linear("layers.{}.self_attn.k_proj.weight"),
            "wv": stack_linear("layers.{}.self_attn.v_proj.weight"),
            "wo": stack_linear("layers.{}.self_attn.o_proj.weight"),
            "router": stack_linear("layers.{}.block_sparse_moe.gate.weight"),
            "w_gate": stack_experts("w1"),
            "w_up": stack_experts("w3"),
            "w_down": stack_experts("w2"),
        },
        "final_norm": get("norm.weight"),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = get("lm_head.weight", True)
    return params, cfg
