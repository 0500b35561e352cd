"""Model configs from Hugging Face config objects. Counterpart of the
config half of ``tpushare/models/convert.py``: ``moe_config_from_hf``
(Mixtral) and the ``_rope_scaling`` helper it calls. Fields are read by
name from any object, so a ``transformers`` config, a
``types.SimpleNamespace`` of a published ``config.json`` or anything
alike works, and nothing is downloaded or imported."""

from __future__ import annotations

import torch

from tpushare_torch.models.moe import MoEConfig


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
