"""Training loop driver. Counterpart of ``tpushare/models/trainer.py``.

``fit`` drives any (params, opt_state, tokens) -> (params, opt_state,
loss) step (``training.adamw_train_step`` or a step from
``training.make_adamw_spmd_train_step``), logs the loss and tokens/s
every ``log_every`` steps, and returns the losses. Data order is the
caller's: pass a deterministic iterator (``utils/data.py``'s
``token_batches`` at ``start_step``).

Checkpointing is the glue between the train steps and the tenant
lifecycle: a bin-packed training pod can be preempted or rescheduled at
any time, so ``fit`` writes params, optimizer state and step to
``ckpt_dir/step_<n>`` every ``ckpt_every`` steps (``save_state``; one
safetensors file, ``utils/checkpoint.py``) and ``load_state`` +
``latest_checkpoint`` resume bit for bit. A step over a tp or ep mesh
(``training.SpmdStep``) writes through its own ``save_state``: the
whole leaves gathered from the ranks' slices (``training.tp_gather``),
the file the reference's save of its global arrays writes, and
``load_state(shardings=step.load_shardings())`` reads each rank's slices
back onto any tp / ep shape (the rescheduled-tenant path). The steps
update params IN PLACE, so a caller that keeps a tree across a ``fit``
passes a copy.

MFU telemetry: with ``flops_per_step`` each log line after the warm-up
window carries `` | mfu X%`` against the card's peak
(``utils/profiling.py``); on the CPU or a card the peak tables do not
hold it carries none.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, Optional, Tuple

import torch

from tpushare_torch import DeviceLike
from tpushare_torch.utils import checkpoint, profiling

log = logging.getLogger("tpushare_torch.trainer")

StepFn = Callable[..., Tuple[Any, Any, Any]]


def save_state(path: str, params: Any, opt_state: Any, step: int) -> int:
    """Write {"params", "opt_state", "step"} to ``path``; returns the
    file's bytes."""
    return checkpoint.save(path, {
        "params": params, "opt_state": opt_state,
        "step": torch.tensor(step, dtype=torch.int32)})


def load_state(path: str, *, like_params: Any, like_opt: Any,
               shardings: Optional[Dict[str, Any]] = None,
               device: DeviceLike = None):
    """Restore (params, opt_state, step) shaped and typed like
    ``like_params`` / ``like_opt``, each leaf on its ``like`` leaf's
    device unless ``device`` says otherwise. ``shardings`` (the
    reference's remap onto a new mesh): {"params": tree, "opt_state":
    tree} of ``checkpoint.FlatShard`` leaves (``training.fsdp_shardings``;
    a missing or None entry reads whole), so each rank of an fsdp group
    of any size reads its own slices of a global flat checkpoint;
    ``checkpoint.MeshShard`` leaves read a tp / ep rank's slices of a
    tree saved whole; other placements raise ``NotImplementedError``."""
    like = {"params": like_params, "opt_state": like_opt,
            "step": torch.zeros((), dtype=torch.int32)}
    sh = None
    if shardings is not None:
        sh = {"params": shardings.get("params"),
              "opt_state": shardings.get("opt_state"), "step": None}
    state = checkpoint.restore(path, like=like, shardings=sh,
                               device=device)
    return state["params"], state["opt_state"], int(state["step"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """Newest ``step_<n>`` checkpoint in ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(name[5:]) for name in os.listdir(ckpt_dir)
             if name.startswith("step_") and name[5:].isdigit()]
    if not steps:
        return None
    return os.path.join(ckpt_dir, f"step_{max(steps)}")


def _world_size() -> int:
    """Ranks of the default process group, 1 without one."""
    dist = torch.distributed
    return (dist.get_world_size()
            if dist.is_available() and dist.is_initialized() else 1)


def fit(step_fn: StepFn, params: Any, opt_state: Any,
        batches: Iterable[Any], *,
        steps: int,
        start_step: int = 0,
        ckpt_dir: Optional[str] = None,
        ckpt_every: int = 0,
        log_every: int = 10,
        tokens_per_step: int = 0,
        flops_per_step: float = 0.0) -> Tuple[Any, Any, list]:
    """Run optimizer steps ``start_step`` .. ``steps - 1``; ``batches``
    must already be positioned at ``start_step``. Returns (params,
    opt_state, losses), the losses as 0-d tensors. Every ``log_every``
    steps the loss is read (the device sync that makes the window's
    timing honest) and logged with tokens/s when ``tokens_per_step`` is
    given; the first window holds warm-up and logs no rate. With
    ``flops_per_step`` (e.g. ``profiling.transformer_flops(cfg, B, S,
    training=True)`` for a step over the GLOBAL batch B) the line also
    logs MFU: ``profiling.mfu`` against the peak of the card the step's
    loss is on, times the world size when ``torch.distributed`` is
    initialized (each rank is a process of its own), else 1; none on
    the CPU or a card the tables do not hold. With
    ``ckpt_dir`` and ``ckpt_every``, the state after every
    ``ckpt_every``-th step lands in ``ckpt_dir/step_<n>``, through the
    step's own ``save_state`` where it has one (a sharded step: whole
    leaves).
    """
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
            if warmed and flops_per_step and dt > 0:
                m = profiling.mfu(
                    flops_per_step, dt / window_steps,
                    profiling.card_key(loss.device),
                    n_chips=_world_size())
                if m is not None:
                    msg += f" | mfu {100 * m:.1f}%"
            log.info("%s", msg)
            window_t0 = time.perf_counter()
            window_steps = 0
            warmed = True
        if ckpt_dir and ckpt_every and (step + 1) % ckpt_every == 0:
            path = os.path.join(ckpt_dir, f"step_{step + 1}")
            getattr(step_fn, "save_state", save_state)(
                path, params, opt_state, step + 1)
            log.info("checkpointed %s", path)
    return params, opt_state, losses
