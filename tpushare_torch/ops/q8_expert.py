"""Fused int8 MoE expert FFN: the wrapper around the hand-written Hopper
kernel ``csrc/q8_expert.cu``, with its plain PyTorch version beside it.
Counterpart of ``tpushare/ops/q8_expert.py``.

    y[e] = (act((x . Wg[e]) * sg[e]) * ((x . Wu[e]) * su[e])) . Wd[e] * sd[e]

straight from int8 expert weights with f32 per-output-channel scales
(``quant.quantize_layers`` leaves of one layer): the scale multiplies the
products after each dot and every sum is f32, so no wide copy of a
weight matrix is ever made.

- ``q8_expert_ffn``: the kernel wrapper. ``x`` [C, Dm] (one token block
  every expert runs: dense dispatch) or [E, C, Dm] (per-expert queues:
  capacity dispatch); returns [E, C, Dm] in x's type. On CUDA tensors it
  launches the kernel or raises; on CPU tensors it runs the plain version.
  Launches are counted in ``q8_expert_ffn.launches``.
- ``q8_expert_ffn_reference``: the plain version (same math, same order).
- ``q8_expert_dispatch``: the one seam ``models/moe.py`` calls.

The TPU package gates its kernel behind an opt-in env var and a VMEM
token-block budget that sends prefill-sized blocks to the reference;
those are TPU facts, so the port's kernel takes every C and always
launches on CUDA.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from tpushare_torch.ops import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODE = {"silu": 0, "gelu": 1}
KERNEL_TILE = 128            # Dm and F must be multiples of this


def _apply_act(name: str, x: torch.Tensor) -> torch.Tensor:
    """silu, or gelu with the tanh approximation (jax.nn.gelu's
    default); ``models/transformer.py`` uses it as its ``_act``."""
    if name == "silu":
        return F.silu(x)
    if name == "gelu":
        return F.gelu(x, approximate="tanh")
    raise ValueError(f"unknown activation {name!r}")


def q8_expert_ffn_reference(x: torch.Tensor, wgq: torch.Tensor,
                            wgs: torch.Tensor, wuq: torch.Tensor,
                            wus: torch.Tensor, wdq: torch.Tensor,
                            wds: torch.Tensor, *,
                            act: str = "silu") -> torch.Tensor:
    """Plain version of the kernel: f32 products of x with the widened
    int8 weights, each scaled per output channel after its dot, the
    activation and the down product in f32; output in x's type."""
    xf = x.float()
    eq = "cd,edf->ecf" if x.ndim == 2 else "ecd,edf->ecf"
    g = torch.einsum(eq, xf, wgq.float()) * wgs
    u = torch.einsum(eq, xf, wuq.float()) * wus
    ff = _apply_act(act, g) * u
    y = torch.einsum("ecf,efd->ecd", ff, wdq.float()) * wds
    return y.to(x.dtype)


def _checks(x, wgq, wgs, wuq, wus, wdq, wds, act):
    tensors = (x, wgq, wgs, wuq, wus, wdq, wds)
    dev = x.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"q8_expert_ffn: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError("q8_expert_ffn: kernel needs contiguous tensors")
    if wgq.ndim != 3:
        raise ValueError(f"q8_expert_ffn: w_gate must be [E, Dm, F], got "
                         f"{tuple(wgq.shape)}")
    E, Dm, Fd = wgq.shape
    if (tuple(wuq.shape) != (E, Dm, Fd) or tuple(wdq.shape) != (E, Fd, Dm)
            or tuple(wgs.shape) != (E, 1, Fd)
            or tuple(wus.shape) != (E, 1, Fd)
            or tuple(wds.shape) != (E, 1, Dm)):
        raise ValueError("q8_expert_ffn: weights must be int8 [E,Dm,F] x2 "
                         "and [E,F,Dm] with f32 scales [E,1,F] x2, [E,1,Dm]")
    if x.ndim not in (2, 3) or x.shape[-1] != Dm or (
            x.ndim == 3 and x.shape[0] != E):
        raise ValueError(f"q8_expert_ffn: x must be [C, {Dm}] or "
                         f"[{E}, C, {Dm}], got {tuple(x.shape)}")
    if any(w.dtype != torch.int8 for w in (wgq, wuq, wdq)) or any(
            s.dtype != torch.float32 for s in (wgs, wus, wds)):
        raise ValueError("q8_expert_ffn: kernel takes int8 weights with f32 "
                         "scales")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"q8_expert_ffn: kernel takes f32 or bf16 x, got "
                         f"{x.dtype}")
    if Dm % KERNEL_TILE or Fd % KERNEL_TILE:
        raise ValueError(f"q8_expert_ffn: kernel takes d_model and d_ff in "
                         f"multiples of {KERNEL_TILE}, got {Dm}, {Fd}")
    if act not in _ACT_CODE:
        raise ValueError(f"unknown activation {act!r}")


def q8_expert_ffn(x: torch.Tensor, wgq: torch.Tensor, wgs: torch.Tensor,
                  wuq: torch.Tensor, wus: torch.Tensor, wdq: torch.Tensor,
                  wds: torch.Tensor, *, act: str = "silu") -> torch.Tensor:
    """Batched expert FFN straight off int8 weights -> [E, C, Dm] in
    x's type. On CUDA: f32 or bf16 x, d_model and d_ff multiples of 128,
    any C. On CPU: ``q8_expert_ffn_reference``."""
    if x.device.type == "cpu":
        return q8_expert_ffn_reference(x, wgq, wgs, wuq, wus, wdq, wds,
                                       act=act)
    _checks(x, wgq, wgs, wuq, wus, wdq, wds, act)
    E, Dm, Fd = wgq.shape
    C = x.shape[-2]
    y = torch.empty((E, C, Dm), dtype=x.dtype, device=x.device)
    if C == 0:
        return y
    # Scratch between the kernel's two passes: ff in f32 (f32 x), or as
    # its three bf16 terms (bf16 x; csrc/q8_expert.cu says why three).
    ff = (torch.empty((E, C, Fd), dtype=torch.float32, device=x.device)
          if x.dtype == torch.float32 else
          torch.empty((3, E, C, Fd), dtype=torch.bfloat16,
                      device=x.device))
    fn = _build.load("q8_expert").ts_q8_expert_ffn
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    code = fn(x.data_ptr(), wgq.data_ptr(), wgs.data_ptr(), wuq.data_ptr(),
              wus.data_ptr(), wdq.data_ptr(), wds.data_ptr(), ff.data_ptr(),
              y.data_ptr(), E, C, Dm, Fd, int(x.ndim == 2),
              _DTYPE_CODE[x.dtype], _ACT_CODE[act],
              torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "q8_expert_ffn")
    q8_expert_ffn.launches += 1
    return y


q8_expert_ffn.launches = 0


def q8_expert_dispatch(x, wgq, wgs, wuq, wus, wdq, wds, *,
                       act: str = "silu") -> torch.Tensor:
    """The one seam ``models/moe.py`` calls: the kernel on CUDA tensors,
    the plain version on CPU tensors (``q8_expert_ffn``'s own rule)."""
    return q8_expert_ffn(x, wgq, wgs, wuq, wus, wdq, wds, act=act)
