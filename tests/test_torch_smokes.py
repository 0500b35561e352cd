"""The port's CI storm smokes (ROADMAP A17: ``chaos/smoke.py``,
``slo/smoke.py``, ``durable/smoke.py``) and the host-kill smoke
(``parallel/multihost_smoke.py``), on the CPU at ``--preset tiny``.

Each smoke keeps the reference's exit rule and JSON keys: it passes
here, and it fails where a planted defect is set — a replay that drops a
token (chaos), tiers disabled (slo: every tier one rank, so nothing is
preempted for the latency tier), the journal off (durable: nothing to
recover, no dedupe). The chaos and SLO smokes arm the ownership
sanitizer as the reference's do (``tests/test_ownership.py``
``test_smokes_arm_the_sanitizer``).
"""

import argparse
import json
import os
import subprocess
import sys

import pytest

from tpushare.chaos import smoke as jchaos_smoke

from tpushare_torch.chaos import smoke as chaos_smoke
from tpushare_torch.durable import smoke as durable_smoke
from tpushare_torch.slo import smoke as slo_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["--device", "cpu", "--preset", "tiny"]


@pytest.fixture(autouse=True)
def restore_env():
    """The smokes arm the ownership sanitizer in the env they run in:
    restore the whole env after each test."""
    saved = dict(os.environ)
    yield
    os.environ.clear()
    os.environ.update(saved)


def _record(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("family", ["dense", "moe_rows", "moe_paged"])
def test_chaos_smoke_passes(family, capsys):
    assert chaos_smoke.main(["--family", family, *CPU]) == 0
    rec = _record(capsys)
    assert rec["ok"] is True and rec["replays"] > 0
    assert rec["mismatched"] == rec["lost_or_dirty"] == rec["hung"] == 0
    # The reference's record keys, and the port's additions.
    keys = {"ok", "family", "spec", "requests", "token_exact",
            "clean_503", "mismatched", "lost_or_dirty", "hung",
            "engine_alive", "replays", "quarantines", "deadline_breaches",
            "engine_errors", "chaos_fired"}
    assert keys <= set(rec)


def test_chaos_smoke_fails_on_a_replay_that_drops_a_token(monkeypatch,
                                                          capsys):
    from tpushare_torch.cli import serve as tserve

    def drop_one(self):
        """The replay's context loses the last generated token."""
        self.prompt = list(self.prompt) + list(
            self.tokens[self.folded:])[:-1]
        self.folded = len(self.tokens)
    monkeypatch.setattr(tserve._Request, "fold_into_prompt", drop_one)
    assert chaos_smoke.main(["--family", "dense", *CPU]) == 1
    rec = _record(capsys)
    assert rec["ok"] is False and rec["mismatched"] > 0


def test_chaos_smoke_same_defaults_as_the_reference():
    assert chaos_smoke.DEFAULT_SPEC == jchaos_smoke.DEFAULT_SPEC


def _slo_args(**kw):
    args = argparse.Namespace(batch=4, interactive=3, max_tokens=16,
                              timeout_s=180.0, device="cpu",
                              preset="tiny")
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def test_slo_smoke_passes(capsys):
    assert slo_smoke.main(CPU) == 0
    rec = _record(capsys)
    assert rec["ok"] is True
    assert rec["interactive"]["deadline_breaches"] == 0
    assert rec["batch"]["tokens"] > 0 and rec["preemptions"] > 0
    assert {"ok", "hung", "engine_alive", "errors", "interactive",
            "batch", "preemptions", "replays"} <= set(rec)


def test_slo_smoke_fails_with_tiers_disabled():
    """Every tier one rank: no arrival outranks a running slot, so the
    latency tier never preempts and the gate (preemptions > 0) fails."""
    import dataclasses
    from tpushare_torch.slo.tiers import TIERS
    flat = {n: dataclasses.replace(t, rank=0) for n, t in TIERS.items()}
    rec = slo_smoke.run_storm(_slo_args(tier_specs=flat))
    assert rec["ok"] is False and rec["preemptions"] == 0


@pytest.mark.parametrize("journal,want", [("on", 0), ("off", 1)])
def test_durable_smoke(journal, want):
    """A real serve process behind the router, SIGKILLed between waves
    and restarted on its journal: the gate passes, and fails with the
    journal off (nothing recovered, no dedupe)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.durable.smoke", *CPU,
         "--journal", journal, "--timeout-s", "120",
         "--boot-timeout-s", "120"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == want, (rec, out.stderr[-2000:])
    assert rec["ok"] is (want == 0)
    if want == 0:
        assert rec["recovered_requests"] > 0 and rec["dedup_hits"] > 0
        assert rec["mismatched"] == rec["lost_or_dirty"] == 0
    else:
        assert not (rec["recovered_requests"] and rec["dedup_hits"])


def test_multihost_smoke():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.parallel.multihost_smoke",
         *CPU, "--timeout-s", "60"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0, (rec, out.stderr[-2000:])
    assert rec["ok"] and rec["lost"] == []
    assert rec["host_losses"] >= 1 and rec["reshards"] >= 1
    assert rec["grow_backs"] >= 1 and rec["digests_equal"]


def test_smokes_arm_the_sanitizer():
    """Both storm smokes opt in (setdefault: a caller can still force
    0), as the reference's do, and the port's engine installs and
    adopts the guards."""
    for rel in (("tpushare_torch", "chaos", "smoke.py"),
                ("tpushare_torch", "slo", "smoke.py")):
        with open(os.path.join(ROOT, *rel), encoding="utf-8") as f:
            src = f.read()
        assert 'os.environ.setdefault("TPUSHARE_OWNERSHIP_CHECKS", "1")' \
            in src, os.path.join(*rel)
    with open(os.path.join(ROOT, "tpushare_torch", "cli", "serve.py"),
              encoding="utf-8") as f:
        serve_src = f.read()
    assert "_ownership.install(self" in serve_src
    assert "_adopt_ownership" in serve_src
