"""A Mixtral-style sparse-expert decoder with int8 weight-only
quantization: attention and expert matrices int8 with f32 scales per
output channel, router, norms and embeddings bf16. The int8 values are
made on the device from the seed as they are served (no wide copy ever
exists): a rounded normal with its absolute maximum near 127, and scales
that give each matrix a spread of 1 / sqrt(fan-in).

The program is given ``params`` in the port's quantized layout
(``k#q8`` int8 [L, ..., In, Out] and ``k#scale`` f32 [L, ..., 1, Out])
with ``quant.fused_expert_hook``, so the expert products run through
the int8 expert kernel; the reference dequantizes the same int8 tensors
in f32 (``layer``), or, with ``control=True``, re-quantizes them to
int4 per output channel, one step below the stated int8.
"""

from __future__ import annotations

import math
import types
from typing import Dict

import torch

QUANTIZED = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
#: q = round(z * Q_SPREAD) for a standard normal z: absmax about 127.
Q_SPREAD = 127.0 / 4.0


class Model:
    family = "moe"

    def __init__(self, conf: dict, seed: int, device: torch.device):
        from tpushare_torch.models import convert, quant
        self.cfg = convert.moe_config_from_hf(types.SimpleNamespace(**conf),
                                              dtype=torch.bfloat16)
        cfg = self.cfg
        gen = torch.Generator(device=device)
        gen.manual_seed(int(seed) % (1 << 64))
        L, d, F, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
        shapes = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
                  "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d),
                  "w_gate": (E, d, F), "w_up": (E, d, F),
                  "w_down": (E, F, d)}

        def normal(shape, fan_in):
            w = torch.randn(shape, generator=gen, device=device,
                            dtype=torch.bfloat16)
            return w.mul_(1.0 / math.sqrt(fan_in))

        layers: Dict[str, torch.Tensor] = {}
        for k, shp in shapes.items():
            q = torch.empty((L, *shp), dtype=torch.int8, device=device)
            for li in range(L):           # one layer's normal at a time
                z = torch.randn(shp, generator=gen, device=device,
                                dtype=torch.bfloat16)
                q[li] = z.mul_(Q_SPREAD).round_().clamp_(-127, 127)
            fan_in = shp[-2]
            s = torch.rand((L, *shp[:-2], 1, shp[-1]), generator=gen,
                           device=device)
            s.mul_(0.2).add_(0.9).mul_(1.0 / (Q_SPREAD * math.sqrt(fan_in)))
            layers[k + "#q8"], layers[k + "#scale"] = q, s
        layers["ln1"] = torch.ones((L, d), dtype=torch.bfloat16,
                                   device=device)
        layers["ln2"] = torch.ones((L, d), dtype=torch.bfloat16,
                                   device=device)
        layers["router"] = normal((L, d, E), d)
        self.params = {
            "embed": normal((cfg.vocab_size, d), d),
            "layers": layers,
            "final_norm": torch.ones((d,), dtype=torch.bfloat16,
                                     device=device),
        }
        if not cfg.tie_embeddings:
            self.params["unembed"] = normal((d, cfg.vocab_size), d)
        self.engine_kw: Dict = {"model_family": "moe", "kv": "paged",
                                "layers_hook": quant.fused_expert_hook(cfg)}

    # -- what the reference reads ------------------------------------
    def embed(self) -> torch.Tensor:
        return self.params["embed"]

    def final_norm(self) -> torch.Tensor:
        return self.params["final_norm"].float()

    def unembed(self, control: bool = False) -> torch.Tensor:
        w = (self.params["unembed"] if "unembed" in self.params
             else self.params["embed"].T)
        return w.float()

    def layer(self, li: int, control: bool = False) -> Dict:
        lay = self.params["layers"]
        out = {"ln1": lay["ln1"][li].float(), "ln2": lay["ln2"][li].float(),
               "router": lay["router"][li].float()}
        for k in QUANTIZED:
            w = lay[k + "#q8"][li].float() * lay[k + "#scale"][li]
            out[k] = int4_roundtrip(w) if control else w
        return out


def int4_roundtrip(w: torch.Tensor) -> torch.Tensor:
    """[..., In, Out] -> f32 through symmetric int4 per output channel."""
    s = torch.clamp(w.abs().amax(dim=-2, keepdim=True) / 7.0, min=1e-12)
    return torch.clamp(torch.round(w / s), -7, 7) * s
