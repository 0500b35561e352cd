"""Mixed-tier SLO storm smoke: the CI teeth of the tier contract.
Counterpart of ``tpushare/slo/smoke.py``: the same exit rule and JSON
keys, over the port's engine.

Saturates a real engine with ``batch`` traffic, then lands
``interactive`` requests on the full pool and asserts what the tier
machinery promises:

  * nothing is lost — every submission terminates cleanly (no errors:
    the storm is chaos-free, so a 503 here is a scheduling bug);
  * ZERO ``interactive`` deadline breaches (TTFT and per-token) —
    preempt-low-for-high and the strict-priority tick override must
    protect the latency tier while the pool is saturated;
  * ``batch`` throughput stays > 0 — protection must not starve the
    throughput tier (its preempted slots replay to completion);
  * the storm actually exercised the machinery (preemptions > 0 — an
    interactive request that never met a full pool proves nothing).

The storm runs TWICE on one engine: an ungraded warm-up pass pays every
first-call cost (kernel module loads, allocator growth, the replay
path's one-off shapes), then the graded pass reruns warm and the gate
reads counter DELTAS across it.

Exit 0 iff all hold; prints one JSON record either way. ``--preset
tiny`` is the CPU size (``--device cpu``); on the card it runs Gemma-2B
(f32, as ``chaos/smoke.py``)::

    python -m tpushare_torch.slo.smoke --device cpu --preset tiny
    python -m tpushare_torch.slo.smoke --batch 6 --interactive 4
"""

from __future__ import annotations

import argparse
import json
import os
import time


def _storm_once(engine, cfg, args, seed: int):
    """One full mixed-tier storm through ``engine``: saturate with
    batch, land interactive on the full pool, wait out the backlog.
    Returns (hung, errors, stats, alive)."""
    import numpy as np

    from tpushare_torch.cli.serve import _Request

    rng = np.random.default_rng(seed)
    batch_prompt_len, inter_prompt_len = 12, 8
    deadline = time.time() + args.timeout_s

    def submit(tier, plen, max_tokens):
        req = _Request([int(t) for t in rng.integers(0, cfg.vocab_size,
                                                     plen)],
                       max_tokens, None, tier=tier)
        if not engine.submit(req):
            raise RuntimeError("bounded queue refused a smoke request")
        return req

    batch_reqs = [submit("batch", batch_prompt_len, args.max_tokens)
                  for _ in range(args.batch)]
    # Land interactive traffic only once the pool is saturated — the
    # whole point is meeting a FULL pool, not an idle one.
    while engine.active_count() < 2 and time.time() < deadline:
        time.sleep(0.002)
    inter_reqs = [submit("interactive", inter_prompt_len, 4)
                  for _ in range(args.interactive)]
    hung = 0
    for r in inter_reqs + batch_reqs:
        if not r.done.wait(timeout=max(0.1, deadline - time.time())):
            hung += 1
    errors = [r.error for r in inter_reqs + batch_reqs
              if r.error is not None]
    return hung, errors, engine.stats(), engine.healthy()


def run_storm(args) -> dict:
    # Arm the runtime ownership sanitizer for the storm (free when the
    # env var is unset; setdefault keeps the caller's explicit =0).
    os.environ.setdefault("TPUSHARE_OWNERSHIP_CHECKS", "1")
    import dataclasses

    import torch

    from tpushare_torch import resolve_device
    from tpushare_torch.chaos.smoke import launches
    from tpushare_torch.cli.serve import ServeEngine
    from tpushare_torch.models import transformer as tt

    dev = resolve_device(args.device or None)
    preset = args.preset or ("tiny" if dev.type == "cpu" else "gemma_2b")
    cfg = dataclasses.replace({"tiny": tt.tiny, "gemma_2b": tt.gemma_2b}[
        preset](), dtype=torch.float32)
    params = tt.init_params(0, cfg, device=dev)
    engine = ServeEngine(params, cfg, n_slots=2, n_blocks=96,
                         block_size=8 if preset == "tiny" else 16,
                         max_blocks_per_slot=24, idle_sleep_s=0.001,
                         tier_specs=getattr(args, "tier_specs", None),
                         device=dev)
    del params
    engine.start()

    # Warm-up: the IDENTICAL storm once, ungraded; the graded storm then
    # reruns every shape warm on the same engine, and the gate reads
    # counter DELTAS across it so warm-up breaches never count.
    hung, _, warm_stats, _ = _storm_once(engine, cfg, args, seed=7)
    if hung:
        engine.stop()
        return {"ok": False, "error": "warm-up storm hung"}

    hung, errors, stats, alive = _storm_once(engine, cfg, args, seed=7)
    engine.stop()

    def delta(tier, key):
        return (stats["per_tier"][tier][key]
                - warm_stats["per_tier"][tier][key])

    inter = {k: delta("interactive", k) for k in
             ("completed", "deadline_breaches", "preempted")}
    batch = {k: delta("batch", k) for k in
             ("completed", "preempted", "tokens")}
    preemptions = stats["preempted"] - warm_stats["preempted"]
    ok = (hung == 0 and alive and not errors
          and inter["deadline_breaches"] == 0
          and inter["completed"] == args.interactive
          and batch["tokens"] > 0
          and batch["completed"] == args.batch
          and preemptions > 0)
    # Percentile rings span both passes — reported for the human
    # reading the record, not graded.
    pct = {k: stats["per_tier"]["interactive"][k]
           for k in ("ttft_p99_ms", "per_token_p99_ms")}
    return {
        "ok": ok, "hung": hung, "engine_alive": alive,
        "errors": errors,
        "interactive": dict(inter, **pct),
        "batch": batch,
        "preemptions": preemptions,
        "replays": stats["replays"] - warm_stats["replays"],
        "preset": preset, "device": str(dev),
        "launches": launches(),
    }


def main(argv=None) -> int:
    from tpushare_torch.chaos.smoke import add_device_args
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4,
                    help="batch-tier requests (saturate the 2 slots)")
    ap.add_argument("--interactive", type=int, default=3,
                    help="interactive requests landed on the full pool")
    ap.add_argument("--max-tokens", type=int, default=16,
                    help="batch-tier generation length")
    ap.add_argument("--timeout-s", type=float, default=180.0)
    add_device_args(ap)
    args = ap.parse_args(argv)
    record = run_storm(args)
    print(json.dumps(record), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
