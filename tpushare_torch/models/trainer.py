"""Training loop driver. Counterpart of ``tpushare/models/trainer.py``.

``fit`` drives any (params, opt_state, tokens) -> (params, opt_state,
loss) step (``training.adamw_train_step`` or a step from
``training.make_adamw_spmd_train_step``), logs the loss and tokens/s
every ``log_every`` steps, and returns the losses. Data order is the
caller's: pass a deterministic iterator.

Not ported yet: checkpointing (``ckpt_dir``; the reference's orbax
``utils/checkpoint.py`` moves to safetensors under ROADMAP A12) and the
MFU telemetry (``flops_per_step``; the reference divides by TPU peak
tables; the port's card figures come with the port's benchmark, a
benchmark issue's work, since ``benchmarks/`` is not ported).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Iterable, Optional, Tuple

log = logging.getLogger("tpushare_torch.trainer")

StepFn = Callable[..., Tuple[Any, Any, Any]]

TODO_CKPT = "ROADMAP A12 (utils/checkpoint.py to safetensors)"
TODO_MFU = "the port's benchmark (MFU on the H100; a benchmark issue)"


def fit(step_fn: StepFn, params: Any, opt_state: Any,
        batches: Iterable[Any], *,
        steps: int,
        start_step: int = 0,
        ckpt_dir: Optional[str] = None,
        log_every: int = 10,
        tokens_per_step: int = 0,
        flops_per_step: float = 0.0) -> Tuple[Any, Any, list]:
    """Run optimizer steps ``start_step`` .. ``steps - 1``; ``batches``
    must already be positioned at ``start_step``. Returns (params,
    opt_state, losses), the losses as 0-d tensors. Every ``log_every``
    steps the loss is read (the device sync that makes the window's
    timing honest) and logged with tokens/s when ``tokens_per_step`` is
    given; the first window holds warm-up and logs no rate.
    """
    if ckpt_dir is not None:
        raise NotImplementedError(f"checkpointing (ckpt_dir): {TODO_CKPT}")
    if flops_per_step:
        raise NotImplementedError(f"MFU telemetry (flops_per_step): "
                                  f"{TODO_MFU}")
    losses = []
    it = iter(batches)
    window_t0 = time.perf_counter()
    window_steps = 0
    warmed = False
    for step in range(start_step, steps):
        params, opt_state, loss = step_fn(params, opt_state, next(it))
        losses.append(loss)
        window_steps += 1
        if log_every and (step + 1) % log_every == 0:
            loss_f = float(loss)
            dt = time.perf_counter() - window_t0
            msg = f"step {step + 1} loss {loss_f:.4f}"
            if warmed and tokens_per_step and dt > 0:
                msg += f" | {tokens_per_step * window_steps / dt:,.0f} tok/s"
            log.info("%s", msg)
            window_t0 = time.perf_counter()
            window_steps = 0
            warmed = True
    return params, opt_state, losses
