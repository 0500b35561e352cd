"""The benchmark's own counts of FLOPs and bytes, and its table of peaks.

Everything here is arithmetic on shapes and configuration numbers: no
tensor of the program is read. ``model_token_flops`` counts what the
model needs for one token (the matmuls of the experts the token is
routed to, the causal attention over the keys it attends, and the
output head only where a token is emitted). ``*_work`` count the least
work of one call of each timed kernel entry from its arguments: each
input byte read once, each output byte written once, and the FLOPs its
contract asks for.

Peaks: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part: 989.4 TFLOP/s
dense bf16 (without sparsity) and 3.35 TB/s of HBM3 bandwidth, at the
700 W power limit. Only a card whose ``torch.cuda.get_device_name``
is listed here has peaks; any other card fails the run.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

#: ``torch.cuda.get_device_name`` -> (dense bf16 FLOP/s, HBM bytes/s).
CARD_PEAKS: Dict[str, Tuple[float, float]] = {
    "NVIDIA H100 80GB HBM3": (989e12, 3.35e12),
}


def peaks(card_name: str) -> Tuple[float, float]:
    """(FLOP/s, bytes/s) of ``card_name``; raises for a card the table
    does not hold, so no share is ever read against assumed peaks."""
    try:
        return CARD_PEAKS[card_name]
    except KeyError:
        raise RuntimeError(f"no published peaks for card {card_name!r}; "
                           f"the benchmark knows {sorted(CARD_PEAKS)}")


# -- model FLOPs ------------------------------------------------------

def dims(conf: dict) -> dict:
    """The widths the counts use, from a configuration file's
    Hugging Face keys."""
    d = conf["hidden_size"]
    heads = conf["num_attention_heads"]
    head_dim = conf.get("head_dim") or d // heads
    return {
        "d": d, "layers": conf["num_hidden_layers"], "heads": heads,
        "kv_heads": conf.get("num_key_value_heads", heads),
        "head_dim": head_dim, "ffn": conf["intermediate_size"],
        "vocab": conf["vocab_size"],
        "experts": conf.get("num_local_experts", 0),
        "top_k": conf.get("num_experts_per_tok", 0),
    }


def layer_matmul_params(conf: dict) -> int:
    """Weights one token multiplies by in one layer: q, k, v, o, and the
    FFN of a dense layer or the router and the ``top_k`` experts the
    token is routed to."""
    m = dims(conf)
    d, hd = m["d"], m["head_dim"]
    attn = d * (m["heads"] + 2 * m["kv_heads"]) * hd + m["heads"] * hd * d
    ffn = 3 * d * m["ffn"]
    if m["experts"]:
        return attn + d * m["experts"] + m["top_k"] * ffn
    return attn + ffn


def active_params_per_token(conf: dict) -> int:
    """Parameters a token uses, embedding and output head included (the
    number usually quoted: about 12.9 B for Mixtral-8x7B)."""
    m = dims(conf)
    emb = m["vocab"] * m["d"] * (1 if conf.get("tie_word_embeddings")
                                 else 2)
    return m["layers"] * layer_matmul_params(conf) + emb


def model_token_flops(conf: dict, keys: int, emit: bool) -> float:
    """FLOPs of one token that attends ``keys`` positions (its own
    included) in every layer; ``emit``: the output head runs for it."""
    m = dims(conf)
    per_layer = (2 * layer_matmul_params(conf)
                 + 4 * m["heads"] * m["head_dim"] * keys)
    head = 2 * m["d"] * m["vocab"] if emit else 0
    return float(m["layers"] * per_layer + head)


def prefill_flops(conf: dict, start: int, end: int) -> float:
    """Positions [start, end) of one prompt computed over a cached
    [0, start); the output head runs for the last position only."""
    if end <= start:
        return 0.0
    m = dims(conf)
    n = end - start
    keys = (start + 1 + end) * n / 2          # sum of p + 1 over p
    body = m["layers"] * (2 * layer_matmul_params(conf) * n
                          + 4 * m["heads"] * m["head_dim"] * keys)
    return float(body + 2 * m["d"] * m["vocab"])


def decode_flops(conf: dict, position: int) -> float:
    """One decoded token at ``position`` (it attends position + 1 keys
    and its logits are computed)."""
    return model_token_flops(conf, position + 1, True)


# -- kernel work ------------------------------------------------------

def flash_attention_work(q_shape, k_shape, q_offset: int, elt: int,
                         window: Optional[int] = None
                         ) -> Tuple[float, float]:
    """(FLOPs, bytes) of causal attention of q [B, Sq, H, D] at absolute
    positions q_offset.. over k, v [B, Sk, Hkv, D]: query i attends keys
    0..min(q_offset + i, Sk - 1), within ``window`` when given."""
    B, Sq, H, D = q_shape
    Sk, Hkv = k_shape[1], k_shape[2]
    pos = q_offset + np.arange(Sq)
    hi = np.minimum(pos + 1, Sk)
    lo = np.zeros_like(hi) if window is None else np.maximum(pos - window + 1,
                                                             0)
    keys = np.clip(hi - lo, 0, None)
    flops = 4.0 * B * H * D * float(keys.sum())
    k_read = int(min(Sk, q_offset + Sq))
    io = (2 * B * Sq * H * D + 2 * B * k_read * Hkv * D) * elt
    return flops, float(io)


def paged_keys(table: np.ndarray, pos: np.ndarray, Sq: int,
               block_size: int) -> np.ndarray:
    """[B, Sq] keys each query row of a paged call attends: row s of
    slot b sees positions <= pos[b] + s that lie under an allocated
    (>= 0) table entry."""
    B, mb = table.shape
    alloc = (table >= 0).astype(np.int64)
    cum = np.concatenate([np.zeros((B, 1), np.int64),
                          np.cumsum(alloc, axis=1)], axis=1)
    limit = np.minimum(pos.astype(np.int64)[:, None] + np.arange(Sq)[None, :]
                       + 1, mb * block_size)          # positions < limit
    limit = np.maximum(limit, 0)
    page, part = limit // block_size, limit % block_size
    full = np.take_along_axis(cum, page, axis=1) * block_size
    tail_alloc = np.take_along_axis(
        np.concatenate([alloc, np.zeros((B, 1), np.int64)], axis=1),
        page, axis=1)
    return full + part * tail_alloc


def paged_attention_work(table: np.ndarray, pos: np.ndarray, q_shape,
                         block_size: int, q_elt: int, kv_elt: int,
                         kv_heads: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one paged decode (Sq = 1) or verify call:
    every query row's keys (``paged_keys``); each slot's live keys and
    values read once, q read and the output written once, the table and
    positions read once."""
    B, Sq, H, D = q_shape
    keys = paged_keys(table, pos, Sq, block_size)
    flops = 4.0 * H * D * float(keys.sum())
    kv = 2 * float(keys[:, -1].sum()) * kv_heads * D * kv_elt
    io = 2.0 * B * Sq * H * D * q_elt + 4.0 * (table.size + pos.size)
    return flops, kv + io


def q8_expert_work(rows: int, routed: int, experts_used: int, d: int,
                   ffn: int, x_elt: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of the routed work of one int8 expert FFN call:
    ``rows`` token rows in, ``routed`` (token, expert) assignments the
    router made among them, touching ``experts_used`` experts. Three
    products of 2 * Dm * F FLOPs an assignment; the int8 weights and
    f32 per-channel scales of the touched experts read once, each token
    row read once, each assignment's output row written once. What the
    kernel is handed beyond that (dense dispatch gives every expert
    every row) is work the count leaves out."""
    flops = 2.0 * routed * 3 * d * ffn
    x_bytes = float(rows) * d * x_elt
    w_bytes = experts_used * (3 * d * ffn + 4 * (2 * ffn + d))
    y_bytes = float(routed) * d * x_elt
    return flops, x_bytes + w_bytes + y_bytes


def least_seconds(flops: float, nbytes: float, card_name: str) -> float:
    """The roofline: the larger of FLOPs over peak FLOP/s and bytes over
    peak bandwidth."""
    pf, pb = peaks(card_name)
    return max(flops / pf, nbytes / pb)
