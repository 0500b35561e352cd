"""Whole runs of the harness on the CPU at a tiny size: a sound run is
correct and reports its metrics; a run whose timed path is broken
underneath comes out not correct, for each fault a served cell can
have."""

import ast
import math
import os
import subprocess
import sys
import time

import pytest
import torch

from portbench import harness
from portbench.tests import tiny

CPU = torch.device("cpu")
#: Sound tiny runs read gaps up to ~0.02 (dense) and ~1.1 (where bf16
#: router logits flip a token's expert); a wrong token reads ~3.
LIMIT = 2.0
#: Short prompts and long answers, so that most served tokens come from
#: decode steps.
FAULT_MIX = dict(tiny.RAG, prompt={"dist": "uniform", "min": 16, "max": 32},
                 output={"dist": "uniform", "min": 24, "max": 32})


def _run(conf, mix, traced=False, seed=2 ** 31 + 77):
    res = harness.run_cell(tiny.cell(conf, mix, LIMIT), seed, 2.0, traced,
                           time.monotonic(), device=CPU)
    return res, res.pop("_run")


@pytest.mark.parametrize("conf,mix", [(tiny.DENSE, tiny.RAG),
                                      (tiny.MOE, tiny.RAG),
                                      (tiny.DENSE, tiny.LONGDOC)],
                         ids=["dense-rag", "moe-rag", "dense-longdoc"])
def test_sound_run(conf, mix):
    res, run = _run(conf, mix)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"output_tok_s", "ttft_p90_ms",
                                   "itl_p95_ms", "setup_s"}
    assert all(math.isfinite(m["value"]) and m["value"] > 0
               for m in res["metrics"].values())
    assert list(res)[-1] == "checks"
    assert res["device"]["platform"] == "cpu"
    if mix is tiny.LONGDOC:
        hit = run.delta("prefix_hit_tokens") / run.delta(
            "prefix_prompt_tokens")
        assert hit > 0.8


def test_traced_run_reports_counters_and_no_device_numbers_off_a_card():
    res, _ = _run(tiny.DENSE, tiny.LONGDOC, traced=True)
    assert res["correct"]
    m = res["metrics"]
    assert m["engine.tokens_per_tick"]["value"] > 1
    assert m["paged.prefix_hit_pct"]["value"] > 80
    # No card: no MFU, roofline or idle share is written.
    assert not any(k.startswith(("kernel.", "device.", "model."))
                   for k in m)
    assert "busy_s" in res["device"] and "breakdown" in res


def test_traced_moe_run_counts_the_routed_expert_rows(monkeypatch):
    """Every expert call in the traced part carries the router's choices
    for its own token block, and its work counts the routed rows."""
    from portbench import trace
    seen = []
    uninstall = trace.KernelSpans.uninstall

    def keep_calls(self):
        seen.extend(self.calls)
        uninstall(self)
    monkeypatch.setattr(trace.KernelSpans, "uninstall", keep_calls)
    res, run = _run(tiny.MOE, tiny.RAG, traced=True)
    assert res["correct"]
    q8 = [rec for family, _, rec in seen if family == "q8_expert"]
    assert q8 and all(r["top_i"] is not None
                      and r["top_i"].numel() == 2 * r["rows"] for r in q8)
    work = harness.kernel_work(seen, "NVIDIA H100 80GB HBM3")
    assert work["q8_expert"] > 0
    # The untraced part comes first and holds the counters' reading.
    assert run.t0 < run.t_split < run.t1
    assert res["untraced_tok_s"] > 0


def _alter_tokens(monkeypatch):
    from tpushare_torch.models import serving
    orig = serving.TokenSampler.pick

    def pick(self, logits):
        return (orig(self, logits) + 1) % logits.shape[-1]
    monkeypatch.setattr(serving.TokenSampler, "pick", pick)


def _state_unchanged(monkeypatch):
    """The paged layers write their new keys and values into copies: the
    pool the next step reads keeps its old state."""
    from tpushare_torch.models import moe, transformer
    orig = transformer._paged_attn

    def paged_attn(q, k, v, lk, lv, *rest):
        return orig(q, k, v, lk.clone(), lv.clone(), *rest)
    monkeypatch.setattr(transformer, "_paged_attn", paged_attn)
    monkeypatch.setattr(moe, "_paged_attn", paged_attn)


def _half_batch(monkeypatch):
    """The decode attention leaves out the second half of the batch."""
    from tpushare_torch.models import transformer
    orig = transformer.paged_flash_decode

    def decode(q, *a, **kw):
        out = orig(q, *a, **kw)
        out[q.shape[0] // 2:] = 0
        return out
    monkeypatch.setattr(transformer, "paged_flash_decode", decode)


@pytest.mark.parametrize("fault", [_alter_tokens, _state_unchanged,
                                   _half_batch],
                         ids=["token-altered", "state-unchanged",
                              "half-batch"])
@pytest.mark.parametrize("conf", [tiny.DENSE, tiny.MOE],
                         ids=["dense", "moe"])
def test_broken_timed_path_is_not_correct(monkeypatch, fault, conf):
    fault(monkeypatch)
    res, _ = _run(conf, FAULT_MIX)
    assert not res["correct"], res["checks"]
    assert res["checks"]["max_logit_gap"]["value"] > LIMIT


def test_no_forbidden_module_loads():
    """Importing the harness and everything it loads for a run leaves no
    module whose top-level name is jax, jaxlib, flax or tpushare
    (compared whole, so tpushare_torch is not one)."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import portbench.harness as h, portbench.control, "
        "portbench.reference.plain\n"
        "import tpushare_torch.cli.serve, tpushare_torch.models.moe\n"
        "for w in ('mixtral-int8.rag', 'mistral-7b.rag'):\n"
        "    c = h.resolve(w)\n"
        "    for m in c.end_to_end + c.per_layer:\n"
        "        h.load_file(h.PB + '/metrics/' + m['name'] + '.py', 'x')\n"
        "print(','.join(h.forbidden_modules()))\n" % harness.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_compare_whole(monkeypatch):
    import types
    monkeypatch.setitem(sys.modules, "tpushare_torch.fake",
                        types.ModuleType("x"))
    assert "tpushare" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpushare.fake", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("x"))
    assert {"tpushare", "jaxlib"} <= set(harness.forbidden_modules())


def test_sources_import_nothing_forbidden():
    bad = set(harness.FORBIDDEN) | {"benchmarks"}
    for base, dirs, files in os.walk(harness.PB):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(base, f)).read())
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    mods = [node.module]
                else:
                    continue
                for m in mods:
                    assert m.split(".")[0] not in bad, (f, m)


def test_run_without_the_program_prints_no_result(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ exits non-zero
    and prints no result line."""
    import shutil
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.PB, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "mistral-7b.rag",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "{" not in out.stdout
