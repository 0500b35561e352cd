"""How far Llama-3-8B over tp=2 drifts from one card, per seed, on one
device. Two threads stand for the two ranks: each holds its
``transformer.param_specs`` slices, and the all-reduce sums rank 0's
partial and rank 1's through a barrier (a two-rank sum, the same in
either order). Both rank threads and the one-card forward run
``transformer.forward`` over ``tools/multichip.py``'s eight Llama prompts,
at its part B's depth (``multichip.B_LAYERS``), from the same seeded weights, once with the row-parallel partials in f32
(``transformer.tp_matmul``, what the port serves) and once with each
partial rounded to bf16 before the sum.

Run from the repository root:

    python -m tpushare_torch.tools.tp_drift                # the card, seeds 0-3
    python -m tpushare_torch.tools.tp_drift --device cpu --tiny

Prints the card's ``nvidia-smi`` name and power limit (on the card), then
one JSON line per seed: for each variant, each prompt's max |tp - one
card| over the one card's largest |logit| on its last logits row (the row
that ``slice_mesh``'s admission gate reads, ``multichip.LOGIT_REL_TOL``),
their max, and whether both ranks' rows are equal. Exits 2 without a
card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
from types import SimpleNamespace
from typing import Dict, List
from unittest import mock

import torch
import torch.distributed as dist

RANKS = 2


class _ThreadSum:
    """The all-reduce of ``RANKS`` threads, each a rank."""

    def __init__(self):
        self.barrier = threading.Barrier(RANKS)
        self.parts: List[torch.Tensor] = [None] * RANKS
        self.local = threading.local()

    def all_reduce(self, x: torch.Tensor, group=None) -> None:
        self.parts[self.local.rank] = x
        self.barrier.wait()
        total = self.parts[0] + self.parts[1]
        self.barrier.wait()          # both sums read before either write
        x.copy_(total)
        self.barrier.wait()


def _bf16_partials(x, w, group):
    """The row-parallel product with its partial rounded to ``x``'s
    dtype before the sum."""
    part = x @ w
    dist.all_reduce(part, group=group)
    return part


def _last_rows(tt, params, cfg, prompts, dev,
               pctx=None) -> List[torch.Tensor]:
    rows = []
    with torch.inference_mode():
        for p in prompts:
            lg, _ = tt.forward(params, torch.as_tensor(p, device=dev)[None],
                               cfg, pctx=pctx, last_logit_only=True)
            rows.append(lg.reshape(-1, lg.shape[-1])[-1].float().clone())
    return rows


def seed_drift(seed: int, tiny: bool, dev) -> Dict[str, object]:
    """One seed's record (see the module docstring)."""
    from tpushare_torch.models import transformer as tt
    from tpushare_torch.parallel.sharding import shard_tree
    from tpushare_torch.tools.multichip import llama_workload
    _, cfg, prompts, *_ = llama_workload(tiny)
    specs = tt.param_specs(cfg)
    with torch.inference_mode():
        full = tt.init_params(seed, cfg, device=dev)
        ranks = [shard_tree(full, specs, SimpleNamespace(
            sizes={"tp": RANKS}, coords=lambda _r, r=r: {"tp": r}, rank=r,
            device=dev)) for r in range(RANKS)]
    one = _last_rows(tt, full, cfg, prompts, dev)
    del full
    rec: Dict[str, object] = {"seed": seed}
    group = object()                 # stands for the tp process group
    for name, matmul in (("f32_partials", tt.tp_matmul),
                         ("bf16_partials", _bf16_partials)):
        sums, got = _ThreadSum(), [None] * RANKS

        def rank(r):
            sums.local.rank = r
            got[r] = _last_rows(tt, ranks[r], cfg, prompts, dev,
                                tt.ParallelCtx(tp=group))
        with mock.patch.object(dist, "all_reduce", sums.all_reduce), \
                mock.patch.object(tt, "tp_matmul", matmul):
            threads = [threading.Thread(target=rank, args=(r,))
                       for r in range(RANKS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        per = [float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got[0], one)]
        rec[name] = {"max": max(per), "per_prompt": per,
                     "ranks_equal": all(torch.equal(a, b)
                                        for a, b in zip(*got))}
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--tiny", action="store_true")
    ap.add_argument("--seeds", type=int, default=4)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("tp_drift: no CUDA card (pass --device cpu)",
                  file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    dev = torch.device(args.device)
    for seed in range(args.seeds):
        print(json.dumps(seed_drift(seed, args.tiny, dev)), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
