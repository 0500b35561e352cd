"""The correctness check's control on the card, at a size a test run
holds: Mistral-7B's published widths at 4 of its 32 layers, the rag
mix cut to 4 clients. The program's served tokens read a small gap
against the f32 reference; the control (the reference with int8
weights, one step below the stated bf16) reads at least three times
more. Run on the card: ``python -m pytest portbench/tests -m cuda``."""

import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

pytestmark = pytest.mark.cuda
NUMBER = "mean_logit_gap"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's kernels have no CPU "
                    "mode")
    return torch.device("cuda", 0)


def test_control_reads_above_the_program(card):
    conf = harness.load_json(f"{harness.PB}/configs/mistral-7b.json")
    conf = dict(conf, num_hidden_layers=4, activation_reserve_gib=60)
    mix = dict(harness.load_json(f"{harness.PB}/traffic/rag.json"),
               clients=4, n_slots=4)
    cell = tiny.cell(conf, mix, limit=1.0)
    cell.limits["compare"] = {NUMBER: 1.0}
    lower, upper = [], []
    for seed in (2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3):
        res = harness.run_cell(cell, seed, 5.0, False, time.monotonic(),
                               device=card, control=True)
        lower.append(res["checks"][NUMBER]["value"])
        upper.append(res["control"][NUMBER])
    print("program", lower, "control", upper)
    assert max(lower) * 3 <= min(upper), (lower, upper)
