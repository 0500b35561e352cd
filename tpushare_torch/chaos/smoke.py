"""Seeded fault-storm smoke: the CI teeth of the chaos harness.
Counterpart of ``tpushare/chaos/smoke.py``: the same exit rule and JSON
keys, over the port's engine.

Runs the SAME requests through a fault-free oracle engine and a
chaos-injected engine, then asserts the recovery contract every
quarantine/replay path promises:

  * no request is lost — every submission terminates;
  * every request either completes with tokens BIT-IDENTICAL to the
    oracle (replay is token-exact under greedy) or ends in a clean 503;
  * the storm actually exercised the machinery (replays > 0 — a storm
    that injected nothing proves nothing);
  * the engine outlives the storm (healthy, no wedge past the
    per-tick deadline's breach accounting).

Exit 0 iff all hold; prints one JSON record either way (CI greps it,
humans read it). ``--preset tiny`` is the CPU size (``--device cpu``);
on the card the default preset serves at a width the kernels take:
Gemma-2B for ``dense``, Mixtral-8x7B's width at 2 layers with int8
experts through the fused expert kernel for the MoE families, in f32
so that a replay's prefill and the oracle's decode steps agree to the
token::

    python -m tpushare_torch.chaos.smoke --device cpu --preset tiny
    python -m tpushare_torch.chaos.smoke --family moe_paged
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

DEFAULT_SPEC = "forward:raise@p=0.15;token_fetch:nan@p=0.1;seed=11"
FAMILIES = ("dense", "moe_rows", "moe_paged")
#: the preset each family serves on the card
CARD_PRESETS = {"dense": "gemma_2b", "moe_rows": "mixtral_2l",
                "moe_paged": "mixtral_2l"}


def default_preset(family: str, device) -> str:
    """``tiny`` on the CPU, else the family's card preset."""
    import torch
    return "tiny" if torch.device(device).type == "cpu" else \
        CARD_PRESETS[family]


def build_engine(family: str, chaos_spec: str = "", *,
                 preset: str = "tiny", device=None, **kw):
    """(engine, cfg) for ``family`` at ``preset`` on ``device`` (None:
    the card), in f32 at every preset. Weights come from seed 0, as the
    serve CLI makes them (``tpushare_torch.cli.serve --seed 0``)."""
    import torch

    from tpushare_torch import resolve_device
    from tpushare_torch.cli.serve import ServeEngine

    dev = resolve_device(device)
    dtype = torch.float32
    if family not in FAMILIES:
        raise SystemExit(f"unknown family {family!r}")
    if family == "dense":
        from tpushare_torch.models import transformer as tt
        cfg = {"tiny": tt.tiny, "gemma_2b": tt.gemma_2b}[preset]()
        cfg = dataclasses.replace(cfg, dtype=dtype)
        params = tt.init_params(0, cfg, device=dev)
        bs = 8 if preset == "tiny" else 16
        return ServeEngine(params, cfg, n_slots=2, n_blocks=48,
                           block_size=bs, max_blocks_per_slot=12,
                           idle_sleep_s=0.001, chaos_spec=chaos_spec,
                           device=dev, **kw), cfg
    from tpushare_torch.models import moe
    hook = None
    if preset == "tiny":
        cfg = dataclasses.replace(moe.tiny(), dtype=dtype)
        params = moe.init_params(0, cfg, device=dev)
    elif preset == "mixtral_2l":
        from tpushare_torch.models import quant
        from tpushare_torch.tools.multichip import moe_weights, moe_workload
        cfg = dataclasses.replace(moe_workload(False)[0], dtype=dtype,
                                  n_layers=2)
        params = moe_weights(cfg, 0, dev)
        hook = quant.fused_expert_hook(cfg)
    else:
        raise SystemExit(f"unknown preset {preset!r} for {family}")
    if family == "moe_rows":
        return ServeEngine(params, cfg, model_family="moe", n_slots=2,
                           max_len=128, idle_sleep_s=0.001,
                           layers_hook=hook, chaos_spec=chaos_spec,
                           device=dev, **kw), cfg
    return ServeEngine(params, cfg, model_family="moe", kv="paged",
                       n_slots=2, n_blocks=48,
                       block_size=8 if preset == "tiny" else 16,
                       layers_hook=hook, idle_sleep_s=0.001,
                       chaos_spec=chaos_spec, device=dev, **kw), cfg


def run_requests(engine, prompts, max_tokens: int, timeout_s: float):
    """Submit every prompt, wait for every terminal transition.
    Returns (results, hung, stats, alive): results[i] = (tokens, error,
    status)."""
    from tpushare_torch.cli.serve import _Request
    engine.start()
    reqs = [_Request(list(p), max_tokens, None) for p in prompts]
    for r in reqs:
        # Plain call, not an assert: `python -O` strips asserts WITH
        # their side effects.
        if not engine.submit(r):
            raise RuntimeError("bounded queue refused a smoke request")
    hung = 0
    deadline = time.time() + timeout_s
    for r in reqs:
        if not r.done.wait(timeout=max(0.1, deadline - time.time())):
            hung += 1
    stats = engine.stats()
    alive = engine.healthy()
    engine.stop()
    return ([(list(r.tokens), r.error, r.status) for r in reqs],
            hung, stats, alive)


def _free(device) -> None:
    import gc

    import torch
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def launches() -> dict:
    """The kernel launches this process counted (nonzero only: none on
    the CPU, where every wrapper takes its plain version)."""
    from tpushare_torch.tools.multichip import read_launches
    return {k: v for k, v in read_launches().items() if v}


def add_device_args(ap) -> None:
    ap.add_argument("--device", default="",
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--preset", default="",
                    help="model size: tiny (the CPU lane) or the card "
                         "size (gemma_2b, mixtral_2l; the default off "
                         "the CPU)")


def main(argv=None) -> int:
    # Storm runs double as the ownership sanitizer's live testbed: the
    # thread-asserting guards (tpushare_torch.utils.ownership) are free
    # when the env var is unset. setdefault so a caller can still opt
    # out with TPUSHARE_OWNERSHIP_CHECKS=0.
    os.environ.setdefault("TPUSHARE_OWNERSHIP_CHECKS", "1")
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--family", default="dense", choices=list(FAMILIES))
    ap.add_argument("--spec", default=DEFAULT_SPEC)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-tokens", type=int, default=6)
    ap.add_argument("--max-replays", type=int, default=30)
    ap.add_argument("--tick-deadline-ms", type=float, default=250.0)
    ap.add_argument("--timeout-s", type=float, default=180.0)
    add_device_args(ap)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from tpushare_torch import resolve_device
    dev = resolve_device(args.device or None)
    preset = args.preset or default_preset(args.family, dev)
    kw = dict(preset=preset, device=dev)
    oracle, cfg = build_engine(args.family, **kw)
    rng = np.random.default_rng(5)
    prompts = [[int(t) for t in rng.integers(0, cfg.vocab_size,
                                             4 + 3 * (i % 4))]
               for i in range(args.requests)]
    want, hung, _, alive = run_requests(oracle, prompts,
                                        args.max_tokens, args.timeout_s)
    del oracle
    _free(dev)
    if hung or not alive or any(err for _, err, _ in want):
        print(json.dumps({"ok": False,
                          "error": "oracle (fault-free) run failed",
                          "results": want}), flush=True)
        return 1

    storm, cfg = build_engine(args.family, chaos_spec=args.spec,
                              max_replays=args.max_replays,
                              tick_deadline_ms=args.tick_deadline_ms,
                              **kw)
    got, hung, stats, alive = run_requests(storm, prompts,
                                           args.max_tokens,
                                           args.timeout_s)
    exact = clean_503 = lost = mismatched = 0
    for (w, _, _), (tokens, err, status) in zip(want, got):
        if err is None and tokens == w:
            exact += 1
        elif err is not None and status == 503:
            clean_503 += 1
        elif err is not None:
            lost += 1           # non-503 failure class: not clean
        else:
            mismatched += 1
    ok = (hung == 0 and alive and mismatched == 0 and lost == 0
          and stats["replays"] > 0 and exact > 0)
    print(json.dumps({
        "ok": ok, "family": args.family, "spec": args.spec,
        "requests": args.requests, "token_exact": exact,
        "clean_503": clean_503, "mismatched": mismatched,
        "lost_or_dirty": lost, "hung": hung, "engine_alive": alive,
        "replays": stats["replays"], "quarantines": stats["quarantines"],
        "deadline_breaches": stats["deadline_breaches"],
        "engine_errors": stats["engine_errors"],
        "chaos_fired": stats.get("chaos_fired"),
        "preset": preset, "device": str(dev),
        "launches": launches(),
    }), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
