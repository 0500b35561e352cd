"""What decides ``correct``: served tokens read against the plain
reference.

Once the window has closed and the program's state is freed, a sample
of the requests the engine finished inside the window is drawn from the
seed, with the longest of them always in it, until it holds the cell's
``sample_tokens`` served tokens or ``sample_requests`` requests. The
reference runs once over each prompt with its served tokens; for every
served token it reads how far that token's logit lies below the
reference's best at that position (0 where greedy decoding and the
reference agree). ``max_logit_gap`` is the widest such gap of the
sample and ``mean_logit_gap`` their mean; each number under
``compare`` in the cell's limits file (``portbench/limits/
<workload>.json``) must not exceed its limit there. Each sampled request must also have been served exactly
the number of tokens it asked for.

The control of that comparison (``readings(..., control=True)``) is the
reference itself one precision step below the stated one, put in the
program's place: at each position of the same prompts and served tokens
it reads the gap of the token the lower precision puts first.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

from portbench import loadgen
from portbench.reference import plain

def draw_sample(finished: Sequence, seed: int, tokens: int,
                requests: int) -> List:
    """The longest finished request (prompt and served tokens), then
    others in an order drawn from the seed, until ``tokens`` served
    tokens or ``requests`` requests."""
    if not finished:
        return []
    order = sorted(range(len(finished)),
                   key=lambda i: -(len(finished[i].prompt)
                                   + len(finished[i].tokens)))
    first, rest = order[0], order[1:]
    rng = loadgen.rng_for(seed, 7)
    rest = [rest[i] for i in rng.permutation(len(rest))]
    picks, served = [], 0
    for i in [first] + rest:
        if served >= tokens or len(picks) >= requests:
            break
        picks.append(finished[i])
        served += len(finished[i].tokens)
    return picks


def _gaps(ref: torch.Tensor, toks: torch.Tensor) -> torch.Tensor:
    best = ref.max(dim=-1).values
    return best - ref.gather(-1, toks[:, None])[:, 0]


def _numbers(gaps: torch.Tensor) -> Dict[str, float]:
    return {"max_logit_gap": float(gaps.max()),
            "mean_logit_gap": float(gaps.mean())}


def readings(model, conf: dict, picks: Sequence,
             control: bool = False) -> Dict:
    """The numbers of the served tokens (``max_logit_gap``,
    ``mean_logit_gap``), how many were read and how many were not the
    reference's first choice; with ``control``, the same numbers of the
    control under ``control``, and every token's gap of both."""
    seqs = [list(r.prompt) + list(r.tokens) for r in picks]
    n_prompt = [len(r.prompt) for r in picks]
    ref = plain.served_logits(model, conf, seqs, n_prompt)
    toks = [torch.as_tensor(list(r.tokens), device=lg.device)
            for lg, r in zip(ref, picks)]
    gaps = torch.cat([_gaps(lg, t) for lg, t in zip(ref, toks)])
    out = _numbers(gaps)
    out["served_tokens_read"] = int(gaps.numel())
    out["not_first_choice"] = int(sum(int((lg.argmax(-1) != t).sum())
                                      for lg, t in zip(ref, toks)))
    if control:
        low = plain.served_logits(model, conf, seqs, n_prompt,
                                  control=True)
        cgaps = torch.cat([_gaps(a, b.argmax(-1)) for a, b in zip(ref, low)])
        out["control"] = _numbers(cgaps)
        out["gaps"] = [round(float(g), 5) for g in gaps]
        out["control_gaps"] = [round(float(g), 5) for g in cgaps]
    return out
