"""Plain PyTorch reference of the decoders the benchmark serves:
Mistral-7B (a Llama-style dense decoder) and Mixtral-8x7B (its sparse
sibling: softmax over all experts, the top two kept and renormalized).

f32 throughout with TF32 off, no kernel, no cache, no batching: each
sequence runs whole from its first token. It imports nothing of the
program; the weights come from the benchmark's model object (``layer``,
``embed``, ``unembed``, ``final_norm``), which made them from the seed.
To fit on the card beside the weights it runs layer by layer over all
sequences (one layer's f32 weights alive at a time) and attention in
blocks of query rows.

``served_logits`` returns, for each sequence of prompt and served
tokens, the logits that predict each served token: the rows of
positions P - 1 .. P + T - 2.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import torch

Q_BLOCK = 512


@contextlib.contextmanager
def full_f32():
    """Matmuls in true f32: TF32 off for cuBLAS and cuDNN."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev[:2]
        torch.set_float32_matmul_precision(prev[2])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [S, H, D] at positions 0..S-1, the pairs
    (i, i + D/2) rotated (Hugging Face's rotate_half)."""
    S, _, D = x.shape
    half = D // 2
    inv = theta ** (-torch.arange(half, dtype=torch.float64,
                                  device=x.device) / half)
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v with a causal mask, q [S, H, D], k and
    v [S, Hkv, D] (each kv head serves H / Hkv query heads); blocks of
    Q_BLOCK query rows, each over the keys it can see."""
    S, H, D = q.shape
    G = H // k.shape[1]
    kh = k.repeat_interleave(G, dim=1).transpose(0, 1)     # [H, S, D]
    vh = v.repeat_interleave(G, dim=1).transpose(0, 1)
    out = torch.empty_like(q)
    scale = D ** -0.5
    for a in range(0, S, Q_BLOCK):
        b = min(S, a + Q_BLOCK)
        qb = q[a:b].transpose(0, 1) * scale                 # [H, n, D]
        s = qb @ kh[:, :b].transpose(1, 2)                  # [H, n, b]
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(b, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
        out[a:b] = (torch.softmax(s, dim=-1) @ vh[:, :b]).transpose(0, 1)
    return out


def dense_ffn(h: torch.Tensor, w: Dict) -> torch.Tensor:
    return (torch.nn.functional.silu(h @ w["w_gate"])
            * (h @ w["w_up"])) @ w["w_down"]


def moe_ffn(h: torch.Tensor, w: Dict, top_k: int) -> torch.Tensor:
    """Each token's top_k experts of the router's softmax over all of
    them, ties to the lower index, their weights renormalized to 1."""
    probs = torch.softmax(h @ w["router"], dim=-1)          # [S, E]
    val, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    val, idx = val[:, :top_k], idx[:, :top_k]
    val = val / val.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(w["w_gate"].shape[0]):
        rows, slot = torch.nonzero(idx == e, as_tuple=True)
        if rows.numel() == 0:
            continue
        x = h[rows]
        y = (torch.nn.functional.silu(x @ w["w_gate"][e])
             * (x @ w["w_up"][e])) @ w["w_down"][e]
        out.index_add_(0, rows, y * val[rows, slot][:, None])
    return out


def layer_forward(x: torch.Tensor, w: Dict, conf: dict) -> torch.Tensor:
    """One decoder layer over one whole sequence x [S, d]."""
    S = x.shape[0]
    H = conf["num_attention_heads"]
    Hkv = conf.get("num_key_value_heads", H)
    D = conf.get("head_dim") or conf["hidden_size"] // H
    eps, theta = conf["rms_norm_eps"], conf["rope_theta"]
    h = rms_norm(x, w["ln1"], eps)
    q = rope((h @ w["wq"]).view(S, H, D), theta)
    k = rope((h @ w["wk"]).view(S, Hkv, D), theta)
    v = (h @ w["wv"]).view(S, Hkv, D)
    x = x + causal_attention(q, k, v).reshape(S, H * D) @ w["wo"]
    h = rms_norm(x, w["ln2"], eps)
    if "router" in w:
        return x + moe_ffn(h, w, conf["num_experts_per_tok"])
    return x + dense_ffn(h, w)


def served_logits(model, conf: dict, seqs: Sequence[Sequence[int]],
                  n_prompt: Sequence[int], control: bool = False,
                  device: Optional[torch.device] = None
                  ) -> List[torch.Tensor]:
    """For each token sequence (prompt, then served tokens), the f32
    logits [T, V] that predict its T served tokens. ``control``: the
    model's weights one precision step below the stated one."""
    embed = model.embed()
    dev = device or embed.device
    with torch.inference_mode(), full_f32():
        xs = [embed[torch.as_tensor(list(s), device=dev)].float()
              for s in seqs]
        for li in range(conf["num_hidden_layers"]):
            w = model.layer(li, control=control)
            xs = [layer_forward(x, w, conf) for x in xs]
            del w
        norm, head = model.final_norm(), model.unembed(control=control)
        out = []
        for x, p in zip(xs, n_prompt):
            rows = rms_norm(x[p - 1:-1], norm, conf["rms_norm_eps"])
            out.append(rows @ head)
        return out
