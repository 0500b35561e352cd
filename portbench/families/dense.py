"""A Llama-style dense decoder (Mistral-7B): bf16 weights made on the
device from the seed, served by the port's dense LM over the paged pool.

The program is given ``params`` (the port's stacked layout, built by
``convert.config_from_hf`` from the configuration file's published
keys); the reference is given the same tensors through ``layer`` in
f32, or, with ``control=True``, quantized one step below the stated
bf16: int8 per output channel, symmetric, dequantized to f32.
"""

from __future__ import annotations

import math
import types
from typing import Dict

import torch

MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


class Model:
    family = "dense"

    def __init__(self, conf: dict, seed: int, device: torch.device):
        from tpushare_torch.models import convert
        self.cfg = convert.config_from_hf(types.SimpleNamespace(**conf),
                                          dtype=torch.bfloat16)
        cfg = self.cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 64))
        L, d, F = cfg.n_layers, cfg.d_model, cfg.d_ff

        def normal(shape, fan_in):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.bfloat16)
            return w.mul_(1.0 / math.sqrt(fan_in))

        layers = {
            "ln1": torch.ones((L, d), dtype=torch.bfloat16, device=device),
            "ln2": torch.ones((L, d), dtype=torch.bfloat16, device=device),
            "wq": normal((L, d, cfg.q_dim), d),
            "wk": normal((L, d, cfg.kv_dim), d),
            "wv": normal((L, d, cfg.kv_dim), d),
            "wo": normal((L, cfg.q_dim, d), cfg.q_dim),
            "w_gate": normal((L, d, F), d),
            "w_up": normal((L, d, F), d),
            "w_down": normal((L, F, d), F),
        }
        self.params = {
            "embed": normal((cfg.vocab_size, d), d),
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=torch.bfloat16,
                                     device=device),
        }
        if not cfg.tie_embeddings:
            self.params["unembed"] = normal((d, cfg.vocab_size), d)
        self.engine_kw: Dict = {"model_family": "dense"}

    # -- what the reference reads ------------------------------------
    def embed(self) -> torch.Tensor:
        return self.params["embed"]

    def final_norm(self) -> torch.Tensor:
        return self.params["final_norm"].float()

    def unembed(self, control: bool = False) -> torch.Tensor:
        w = (self.params["unembed"] if "unembed" in self.params
             else self.params["embed"].T)
        return int8_roundtrip(w) if control else w.float()

    def layer(self, li: int, control: bool = False) -> Dict:
        lay = self.params["layers"]
        out = {"ln1": lay["ln1"][li].float(), "ln2": lay["ln2"][li].float()}
        for k in MATRICES:
            w = lay[k][li]
            out[k] = int8_roundtrip(w) if control else w.float()
        return out


def int8_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """[In, Out] -> f32 through symmetric int8 per output channel."""
    x = w.float()
    s = torch.clamp(x.abs().amax(dim=-2, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(x / s), -127, 127) * s
