"""``python -m tpushare_torch.tools.colocate --device cpu --tiny`` as a
whole, on the CPU with 0.5 s windows: Allocate's envs over the one-card
fake node, the tenants' barrier and both windows, the A-B-A record's
keys, and the isolation pair, whose HOG the enforcing guard stops (on
the host it reads the walk's own bytes) while the planted HOG (guard
off, isolation disabled) walks past its grant. The run takes ~30 s; each
subprocess has its own timeout. Speeds here are the host's and are not
checked.
"""

import json
import os
import subprocess
import sys

import pytest

from tpushare_torch.plugin import const
from tpushare_torch.tools import colocate

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MIB = 1 << 20


def _env():
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("NVIDIA_", "CUDA_VISIBLE", "TPUSHARE_",
                                "CTPU_", "ALIYUN_"))}
    env["PYTHONPATH"] = ROOT
    return env


@pytest.fixture(scope="module")
def run():
    out = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.tools.colocate", "--device",
         "cpu", "--tiny", "--seconds", "0.5"], env=_env(), cwd=ROOT,
        capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(l) for l in out.stdout.strip().splitlines()]
    return lines[:-1], lines[-1]


def test_allocate_envs_over_the_fake_card(run):
    _, rec = run
    assert rec["memory_unit"] == const.MIB
    envs = rec["envs"]
    card = int(colocate.FAKE_CARD_GIB * 1024)
    for name, units in (("solo", card), ("co", 16), ("hog", 8),
                        ("steady", 16)):
        e = envs[name]
        assert e[const.ENV_NVIDIA_VISIBLE_DEVICES] == "0"
        assert e[const.ENV_HBM_LIMIT_BYTES] == str(units * MIB)
        assert e[const.ENV_RESOURCE_BY_CONTAINER] == str(units)
        assert e[const.ENV_RESOURCE_BY_DEV] == str(card)


def test_aba_record(run):
    lines, rec = run
    c = rec["colocate"]
    assert set(c) == {"colocated_pct", "solo_variance_pct", "credible",
                      "refusal_reasons", "sat_colocated_pct", "windows"}
    w = c["windows"]
    assert len(w["colocated"]) == 2 and len(c["sat_colocated_pct"]) == 2
    assert c["credible"] == (not c["refusal_reasons"])
    want = 100 * min(t["serve_tokens_per_sec"] for t in w["colocated"]) / (
        (w["solo_a1"]["serve_tokens_per_sec"]
         + w["solo_a2"]["serve_tokens_per_sec"]) / 2)
    assert c["colocated_pct"] == pytest.approx(want)
    assert [l["window"] for l in lines if "window" in l] == \
        ["solo_a1", "colocated", "colocated", "solo_a2"]


def test_every_tenant_ran_both_windows_on_one_output(run):
    _, rec = run
    w = rec["colocate"]["windows"]
    tenants = [w["solo_a1"], *w["colocated"], w["solo_a2"]]
    assert [t["stream"] for t in tenants] == [0, 0, 1, 0]
    assert w["colocated"][0]["cores"] != w["colocated"][1]["cores"] or \
        len(os.sched_getaffinity(0)) < 2
    for t in tenants:
        assert t["device"] == "cpu" and (t["batch"], t["seq"]) == (2, 32)
        assert t["serve_calls"] > 0 and t["sat_calls"] > 0
        assert t["chain_k"] == colocate.CHAIN_K
        assert t["hbm_breaches"] == 0 and t["pooled_finite"]
        assert t["pooled_vs_f32_max_abs"] == 0.0      # tiny is f32 already
        assert "mfu_pct" not in t and "profile" not in t
    assert len({t["pooled_sha256"] for t in tenants}) == 1
    assert w["solo_a1"]["hbm_limit_bytes"] == 128 * MIB
    assert w["colocated"][0]["hbm_limit_bytes"] == 16 * MIB


def test_isolation_hog_stops_at_its_grant(run):
    _, rec = run
    iso = rec["isolation"]
    hog = iso["hog"]
    assert hog["stopped_by"] == "SoftHbmOom"
    assert hog["limit_bytes"] == 8 * MIB and hog["step_bytes"] == MIB // 4
    assert hog["limit_bytes"] < hog["held_bytes"] \
        <= hog["limit_bytes"] + hog["step_bytes"]
    assert hog["within_grant"]
    assert len(iso["steady"]["windows"]) == colocate.ISO_WINDOWS
    assert iso["steady"]["hbm_breaches"] == 0
    assert iso["steady_tokens_per_sec"]["before"] > 0


def test_planted_hog_walks_past_its_grant(run):
    _, rec = run
    p = rec["planted"]
    assert p["stopped_by"] is None and not p["within_grant"]
    assert p["held_bytes"] == p["target_bytes"] == int(
        colocate.HOG_OVERSHOOT * p["limit_bytes"])


def test_without_a_card_the_tool_exits_naming_it():
    out = subprocess.run([sys.executable, "-m",
                          "tpushare_torch.tools.colocate"], env=_env(),
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 2 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def _tenant(serve, sat):
    return {"serve_tokens_per_sec": serve, "sat_tokens_per_sec": sat}


@pytest.mark.parametrize("solo,co,pct,reasons", [
    ((100.0, 100.0), (98.0, 97.0), 97.0, []),
    ((100.0, 120.0), (100.0, 100.0), 100 / 1.1, ["variance"]),
    ((100.0, 100.0), (120.0, 130.0), 120.0, ["100%"]),
])
def test_measure_verdicts(monkeypatch, solo, co, pct, reasons):
    runs = [[_tenant(solo[0], 50.0)], [_tenant(c, 25.0) for c in co],
            [_tenant(solo[1], 50.0)]]
    monkeypatch.setattr(colocate, "run_streams",
                        lambda env, n, args, profile=False: runs.pop(0))
    rec = colocate.measure({}, {}, None, log=lambda s: None)
    assert rec["colocated_pct"] == pytest.approx(pct)
    assert rec["sat_colocated_pct"] == [50.0, 50.0]
    assert rec["credible"] == (not reasons)
    assert len(rec["refusal_reasons"]) == len(reasons)
    for r, want in zip(rec["refusal_reasons"], reasons):
        assert want in r
