"""ResNet-50 (v1.5), BASELINE.md's saturation workload, in PyTorch.
Counterpart of ``tpushare/models/resnet.py``.

Inference only: NHWC images in, batch norm folded into a per-channel
affine (scale 1, bias 0 at init, as the reference's), global average
pool, f32 logits. The tree keeps the reference's nesting ("stem",
"stages" (a list of lists of blocks), "head"); the convolution weights
are in PyTorch's [out, in, kh, kw] layout, stored channels-last
(``bridge.resnet_params_from_jax`` turns the reference's HWIO into it).
An NHWC batch permuted to [B, C, H, W] is a channels-last tensor, so
every convolution runs on cuDNN's NHWC kernels
(``torch.nn.functional.conv2d``; the reference's
``lax.conv_general_dilated`` is not a Pallas kernel either).

XLA's ``"SAME"`` padding puts the odd pixel of a stride-2 window's pad on
the high side (low = total // 2), where PyTorch's ``padding=`` is
symmetric: the stride-2 convolutions and the 3x3/2 max pool (padded with
-inf) pad explicitly with ``F.pad`` (``_same_pads``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch
import torch.nn.functional as F

from tpushare_torch import DeviceLike, resolve_device

# Per-stage (blocks, mid_channels); out_channels = 4 * mid.
RESNET50_STAGES: Tuple[Tuple[int, int], ...] = ((3, 64), (4, 128),
                                                (6, 256), (3, 512))


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stages: Tuple[Tuple[int, int], ...] = RESNET50_STAGES
    n_classes: int = 1000
    stem_channels: int = 64
    dtype: torch.dtype = torch.bfloat16


def resnet50() -> ResNetConfig:
    return ResNetConfig()


def tiny() -> ResNetConfig:
    return ResNetConfig(stages=((1, 8), (1, 16)), n_classes=10,
                        stem_channels=8, dtype=torch.float32)


def num_params(cfg: ResNetConfig) -> int:
    n = 7 * 7 * 3 * cfg.stem_channels + 2 * cfg.stem_channels
    cin = cfg.stem_channels
    for blocks, mid in cfg.stages:
        cout = 4 * mid
        for b in range(blocks):
            n += cin * mid + 9 * mid * mid + mid * cout + 4 * mid + 2 * cout
            if b == 0:
                n += cin * cout + 2 * cout
            cin = cout
    return n + cin * cfg.n_classes + cfg.n_classes


def flops_per_image(cfg: ResNetConfig, size: int = 224) -> int:
    """Multiply-adds x 2 of the convolutions and the head at ``size``."""
    h = -(-size // 2)
    n = 2 * h * h * 49 * 3 * cfg.stem_channels
    h = -(-h // 2)                                          # max pool
    cin = cfg.stem_channels
    for si, (blocks, mid) in enumerate(cfg.stages):
        cout = 4 * mid
        for b in range(blocks):
            stride = 2 if (si > 0 and b == 0) else 1
            ho = -(-h // stride)
            n += 2 * (h * h * cin * mid + ho * ho * 9 * mid * mid
                      + ho * ho * mid * cout)
            if b == 0:
                n += 2 * ho * ho * cin * cout
            h, cin = ho, cout
    return n + 2 * cin * cfg.n_classes


def _conv_init(gen, kh, kw, cin, cout, dtype, dev):
    w = torch.empty((cout, cin, kh, kw), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    w = (w / math.sqrt(kh * kw * cin)).to(dtype)
    return w.contiguous(memory_format=torch.channels_last)


def _bn_init(c, dtype, dev):
    # Inference-mode BN folded to an affine: scale=1, bias=0.
    return {"scale": torch.ones((c,), dtype=dtype, device=dev),
            "bias": torch.zeros((c,), dtype=dtype, device=dev)}


def init_params(gen, cfg: ResNetConfig, *,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Truncated-normal convolutions (in [-2, 2], divided by
    sqrt(fan_in)) from ``gen``, a ``torch.Generator`` on the target
    device or an int seed for one. The values differ from the JAX
    package's for the same seed; ``bridge.resnet_params_from_jax``
    carries its weights across."""
    dev = resolve_device(device)
    if isinstance(gen, int):
        gen = torch.Generator(device=dev).manual_seed(gen)
    dt = cfg.dtype
    params: Dict[str, Any] = {
        "stem": {"conv": _conv_init(gen, 7, 7, 3, cfg.stem_channels, dt,
                                    dev),
                 "bn": _bn_init(cfg.stem_channels, dt, dev)},
        "stages": [],
    }
    cin = cfg.stem_channels
    for blocks, mid in cfg.stages:
        cout = 4 * mid
        stage: List[Dict[str, Any]] = []
        for b in range(blocks):
            blk = {
                "conv1": _conv_init(gen, 1, 1, cin, mid, dt, dev),
                "bn1": _bn_init(mid, dt, dev),
                "conv2": _conv_init(gen, 3, 3, mid, mid, dt, dev),
                "bn2": _bn_init(mid, dt, dev),
                "conv3": _conv_init(gen, 1, 1, mid, cout, dt, dev),
                "bn3": _bn_init(cout, dt, dev),
            }
            if b == 0:
                blk["proj"] = _conv_init(gen, 1, 1, cin, cout, dt, dev)
                blk["proj_bn"] = _bn_init(cout, dt, dev)
            stage.append(blk)
            cin = cout
        params["stages"].append(stage)
    w = torch.empty((cin, cfg.n_classes), dtype=torch.float32, device=dev)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    params["head"] = {"w": (w / math.sqrt(cin)).to(dt),
                      "b": torch.zeros((cfg.n_classes,), dtype=dt,
                                       device=dev)}
    return params


def same_pads(n: int, k: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of XLA's "SAME" along one spatial dim of size
    n: the output is ceil(n / stride), the pad total
    max((out - 1) * stride + k - n, 0), and low = total // 2."""
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int = 1):
    """Conv with "SAME" padding; x [B, C, H, W] (channels-last)."""
    kh, kw = w.shape[2], w.shape[3]
    ph, pw = same_pads(x.shape[2], kh, stride), same_pads(x.shape[3], kw,
                                                          stride)
    if ph[0] == ph[1] and pw[0] == pw[1]:
        return F.conv2d(x, w, stride=stride, padding=(ph[0], pw[0]))
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
    return F.conv2d(x, w, stride=stride)


def _max_pool(x, k: int = 3, stride: int = 2):
    """k x k max pool, "SAME" padding with -inf."""
    ph, pw = same_pads(x.shape[2], k, stride), same_pads(x.shape[3], k,
                                                         stride)
    x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=-math.inf)
    return F.max_pool2d(x, k, stride)


def _bn(x, p):
    return x * p["scale"][:, None, None] + p["bias"][:, None, None]


def _bottleneck(x, blk, stride: int):
    # v1.5: the 3x3 carries the stride.
    out = F.relu(_bn(_conv(x, blk["conv1"]), blk["bn1"]))
    out = F.relu(_bn(_conv(out, blk["conv2"], stride), blk["bn2"]))
    out = _bn(_conv(out, blk["conv3"]), blk["bn3"])
    if "proj" in blk:
        x = _bn(_conv(x, blk["proj"], stride), blk["proj_bn"])
    return F.relu(x + out)


def forward(params: Dict[str, Any], images: torch.Tensor,
            cfg: ResNetConfig) -> torch.Tensor:
    """images [B, H, W, 3] (NHWC) -> logits [B, n_classes] (f32)."""
    x = images.to(cfg.dtype).permute(0, 3, 1, 2)     # channels-last view
    x = F.relu(_bn(_conv(x, params["stem"]["conv"], 2),
                   params["stem"]["bn"]))
    x = _max_pool(x)
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            x = _bottleneck(x, blk, stride)
    x = x.mean(dim=(2, 3))                             # global average pool
    logits = x @ params["head"]["w"] + params["head"]["b"]
    return logits.float()
