"""The control of a cell's correctness check, and the readings its limit
is set from (not part of the benchmark's runs).

    python3 portbench/control.py --workload <name> --seconds <s> \
        --seeds <n>,<n>,...

For each seed, one run of the cell at its own load: the program's
numbers the cell's limits name (the lower readings) and, over the same
sample, the control's (the reference one precision step below the
stated one put in the program's place: the upper readings). One JSON
line per seed, with every served token's gap, then the largest program
reading and the smallest control reading of each number.
"""

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    args = ap.parse_args(argv)

    import torch
    from portbench import harness

    cell = harness.resolve(args.workload)
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA card", file=sys.stderr)
        return 2
    lower, upper = [], []
    for seed in [int(s) for s in args.seeds.split(",")]:
        res = harness.run_cell(cell, seed, args.seconds, False,
                               time.monotonic(), control=True)
        res.pop("_run")
        got = {k: res["checks"][k]["value"] for k in cell.limits["compare"]}
        ctl = res.get("control", {})
        lower.append(got)
        upper.append(ctl)
        print(json.dumps({"seed": seed, "program": got, "control": ctl,
                          "correct": res["correct"],
                          "not_first_choice": res["not_first_choice"],
                          "served_tokens_read": res["served_tokens_read"],
                          "metrics": res["metrics"],
                          "gaps": res.get("gaps"),
                          "control_gaps": res.get("control_gaps")}),
              flush=True)
    print(json.dumps({"workload": args.workload, "readings": {
        k: {"lower": max(g[k] for g in lower),
            "upper": min(c.get(k, float("inf")) for c in upper)}
        for k in cell.limits["compare"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
