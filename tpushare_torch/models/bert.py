"""BERT-style bidirectional encoder — the co-location workload.
Counterpart of ``tpushare/models/bert.py``.

BASELINE.md's north-star configuration runs two BERT-base inference pods
on one card, each targeting ≥95% of whole-card tokens/s
(``tools/colocate.py``). Post-norm blocks (original BERT), learned
position embeddings, tanh-GELU MLP, non-causal attention through
``ops.attention``. Non-causal attention takes ``mha_reference`` there,
as it takes the JAX package's reference (its flash kernel takes head dim
128 or 256 only; BERT's is 64), and the products are ``torch.matmul``,
as they are plain ``x @ w`` outside any Pallas kernel in the original.
Functional params with stacked ``[L, ...]`` leaves, a loop over layers
where the original scans.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import torch

from tpushare_torch import DeviceLike, resolve_device
from tpushare_torch.ops.attention import attention
from tpushare_torch.ops.norms import layer_norm


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30_522
    max_positions: int = 512
    n_segments: int = 2
    d_model: int = 768
    n_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    norm_eps: float = 1e-12
    dtype: torch.dtype = torch.bfloat16

    @property
    def head_dim(self) -> int:
        assert self.d_model % self.n_heads == 0
        return self.d_model // self.n_heads


def bert_base() -> BertConfig:
    return BertConfig()


def tiny(vocab_size: int = 256, d_model: int = 64, n_layers: int = 2,
         n_heads: int = 4, d_ff: int = 128, max_positions: int = 64) -> BertConfig:
    return BertConfig(vocab_size=vocab_size, d_model=d_model,
                      n_layers=n_layers, n_heads=n_heads, d_ff=d_ff,
                      max_positions=max_positions, dtype=torch.float32)


def flops_per_forward(cfg: BertConfig, batch: int, seq: int) -> float:
    """Matmul + attention FLOPs of one encoder forward pass.

    Embedding gathers are excluded; the attention term is the full
    non-causal score/value pair (2+2 FLOPs per B·S²·Dm)."""
    tokens = batch * seq
    per_layer = (4 * cfg.d_model * cfg.d_model       # q, k, v, o projections
                 + 2 * cfg.d_model * cfg.d_ff)       # ffn in + out
    matmul = 2.0 * cfg.n_layers * per_layer * tokens
    pooler = 2.0 * batch * cfg.d_model * cfg.d_model
    attn = cfg.n_layers * 4.0 * batch * seq * seq * cfg.d_model
    return matmul + pooler + attn


def init_params(gen, cfg: BertConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Truncated-normal weights (in [-2, 2], divided by sqrt(fan_in)),
    zero biases, unit norms, stacked over layers. ``gen`` is a
    ``torch.Generator`` on the target device, or an int seed for one.
    The values differ from the JAX package's for the same seed; load
    JAX weights with ``bridge.bert_params_from_jax`` where parity
    matters."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    L, Dm, F = cfg.n_layers, cfg.d_model, cfg.d_ff

    def dense(shape, fan_in):
        w = torch.empty(shape, dtype=torch.float32, device=dev)
        torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (w / math.sqrt(fan_in)).to(cfg.dtype)

    def zeros(*shape):
        return torch.zeros(shape, dtype=cfg.dtype, device=dev)

    def ones(*shape):
        return torch.ones(shape, dtype=cfg.dtype, device=dev)

    return {
        "embed": {
            "tokens": dense((cfg.vocab_size, Dm), Dm),
            "positions": dense((cfg.max_positions, Dm), Dm),
            "segments": dense((cfg.n_segments, Dm), Dm),
            "ln_scale": ones(Dm),
            "ln_bias": zeros(Dm),
        },
        "layers": {
            "wq": dense((L, Dm, Dm), Dm), "bq": zeros(L, Dm),
            "wk": dense((L, Dm, Dm), Dm), "bk": zeros(L, Dm),
            "wv": dense((L, Dm, Dm), Dm), "bv": zeros(L, Dm),
            "wo": dense((L, Dm, Dm), Dm), "bo": zeros(L, Dm),
            "ln1_scale": ones(L, Dm), "ln1_bias": zeros(L, Dm),
            "w1": dense((L, Dm, F), Dm), "b1": zeros(L, F),
            "w2": dense((L, F, Dm), F), "b2": zeros(L, Dm),
            "ln2_scale": ones(L, Dm), "ln2_bias": zeros(L, Dm),
        },
        "pooler": {"w": dense((Dm, Dm), Dm), "b": zeros(Dm)},
    }


def forward(params: Dict[str, Any], tokens: torch.Tensor,
            cfg: BertConfig, *,
            segment_ids: Optional[torch.Tensor] = None,
            attention_mask: Optional[torch.Tensor] = None,
            attn_impl: str = "auto") -> Dict[str, torch.Tensor]:
    """tokens [B, S] (+ optional segment_ids [B, S], attention_mask
    [B, S] of 1/0 valid flags) → {'hidden': [B, S, Dm], 'pooled': [B, Dm]}."""
    B, S = tokens.shape
    H, Dh = cfg.n_heads, cfg.head_dim
    emb = params["embed"]
    x = (emb["tokens"][tokens]
         + emb["positions"][None, :S]
         + (emb["segments"][segment_ids] if segment_ids is not None
            else emb["segments"][0][None, None]))
    x = layer_norm(x.to(cfg.dtype), emb["ln_scale"], emb["ln_bias"],
                   eps=cfg.norm_eps)
    kv_mask = attention_mask.bool() if attention_mask is not None else None
    lp = params["layers"]
    for li in range(cfg.n_layers):
        layer = {k: v[li] for k, v in lp.items()}
        q = (x @ layer["wq"] + layer["bq"]).reshape(B, S, H, Dh)
        k = (x @ layer["wk"] + layer["bk"]).reshape(B, S, H, Dh)
        v = (x @ layer["wv"] + layer["bv"]).reshape(B, S, H, Dh)
        attn = attention(q, k, v, causal=False, kv_mask=kv_mask,
                         impl=attn_impl)
        o = attn.reshape(B, S, H * Dh) @ layer["wo"] + layer["bo"]
        x = layer_norm(x + o, layer["ln1_scale"], layer["ln1_bias"],
                       eps=cfg.norm_eps)
        ff = torch.nn.functional.gelu(x @ layer["w1"] + layer["b1"],
                                      approximate="tanh")
        ff = ff @ layer["w2"] + layer["b2"]
        x = layer_norm(x + ff, layer["ln2_scale"], layer["ln2_bias"],
                       eps=cfg.norm_eps)
    pooled = torch.tanh(x[:, 0] @ params["pooler"]["w"] + params["pooler"]["b"])
    return {"hidden": x, "pooled": pooled}
