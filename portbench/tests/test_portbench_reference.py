"""The plain reference against the port at a tiny size on the CPU: the
port's forward over the benchmark's own weights, in f32, agrees with the
reference's logits; and the served-token check reads 0 on the
reference's own greedy tokens."""

import dataclasses

import torch

from portbench import check
from portbench.reference import plain
from portbench.tests import tiny

CPU = torch.device("cpu")


def _port_logits(model, tokens):
    """The port's plain forward (no cache) in f32 over the model's
    weights."""
    cfg = dataclasses.replace(model.cfg, dtype=torch.float32)
    f32 = {k: (v.float() if v.is_floating_point() else v)
           for k, v in model.params["layers"].items()}
    params = dict(model.params, layers=f32,
                  embed=model.params["embed"].float(),
                  unembed=model.params["unembed"].float(),
                  final_norm=model.params["final_norm"].float())
    with torch.inference_mode():
        if model.family == "moe":
            from tpushare_torch.models import moe, quant
            logits, _ = moe.forward(params, tokens[None], cfg,
                                    layers_hook=quant.fused_expert_hook(cfg))
        else:
            from tpushare_torch.models import transformer
            logits, _ = transformer.forward(params, tokens[None], cfg)
    return logits[0]


def _agree(conf):
    model = tiny.cell(conf, tiny.RAG).family.Model(conf, 1234, CPU)
    torch.manual_seed(0)
    toks = torch.randint(0, conf["vocab_size"], (40,))
    n_prompt = 25
    ref = plain.served_logits(model, conf, [toks.tolist()], [n_prompt])[0]
    port = _port_logits(model, toks)[n_prompt - 1:-1]
    assert ref.shape == port.shape == (15, conf["vocab_size"])
    err = (ref - port).abs().max() / ref.abs().max()
    assert err < 1e-4, float(err)


def test_dense_reference_agrees_with_the_port():
    _agree(tiny.DENSE)


def test_mixtral_reference_agrees_with_the_port():
    _agree(tiny.MOE)


class _Req:
    def __init__(self, prompt, tokens):
        self.prompt, self.tokens = prompt, tokens
        self.max_tokens = len(tokens)


def test_greedy_tokens_of_the_reference_read_zero():
    conf = tiny.DENSE
    model = tiny.cell(conf, tiny.RAG).family.Model(conf, 7, CPU)
    prompt = list(range(3, 23))
    seq = list(prompt)
    for _ in range(6):       # the reference's own greedy continuation
        lg = plain.served_logits(model, conf, [seq + [0]],
                                 [len(seq)])[0]
        seq.append(int(lg[0].argmax()))
    req = _Req(prompt, seq[len(prompt):])
    got = check.readings(model, conf, [req])
    assert got["max_logit_gap"] == 0.0 and got["not_first_choice"] == 0
    req.tokens = [(t + 1) % conf["vocab_size"] for t in req.tokens]
    assert check.readings(model, conf, [req])["max_logit_gap"] > 0.1


def test_control_reads_the_lower_precision():
    conf = tiny.DENSE
    model = tiny.cell(conf, tiny.RAG).family.Model(conf, 7, CPU)
    req = _Req(list(range(5, 40)), list(range(40, 60)))
    got = check.readings(model, conf, [req], control=True)
    assert got["control"]["max_logit_gap"] >= 0.0
    assert len(got["control_gaps"]) == len(got["gaps"]) == 20
    w = model.layer(0)["wq"]
    assert not torch.equal(model.layer(0, control=True)["wq"], w)


def test_sample_holds_the_longest_and_enough_tokens():
    reqs = [_Req([1] * n, [2] * 40) for n in (10, 50, 30, 20, 5, 60, 7, 9)]
    picks = check.draw_sample(reqs, 99, 100, 8)
    assert picks[0] is reqs[5] and len(picks) == 3
    assert check.draw_sample(reqs, 99, 100, 8) == picks
    assert len(check.draw_sample(reqs, 99, 10 ** 6, 5)) == 5
