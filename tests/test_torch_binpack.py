"""``tpushare_torch.tools.binpack`` (BASELINE.md's demo/binpack-1 dry-run
over the port's control plane) as a subprocess on the CPU: the fake
backend, tiny CPU serving tenants and the 0.5 s health poll the tool
sets for a CPU run. Its A-D gates must pass; the record is read back to
check them here as well. Plus its manifest reader against PyYAML, and its refusal
to run without a card unless asked for the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import yaml

from tpushare_torch.plugin import const
from tpushare_torch.tools import binpack

REPO = str(Path(__file__).parent.parent)
TOOL_TIMEOUT_S = 240


def _tool(*argv, timeout=TOOL_TIMEOUT_S, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    for k in ("TPUSHARE_FAKE_CHIPS", "TPUSHARE_BACKEND",
              "TPUSHARE_HEALTH_ERRFILES", "TPUSHARE_DRAIN_URL"):
        env.pop(k, None)
    return subprocess.run(
        [sys.executable, "-m", "tpushare_torch.tools.binpack", *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def record():
    out = _tool("--device", "cpu")
    lines = out.stdout.strip().splitlines()
    assert lines, out.stderr[-2000:]
    rec = json.loads(lines[-1])
    rec["_rc"], rec["_stderr"] = out.returncode, out.stderr[-2000:]
    return rec


def test_binpack_gates_pass_on_the_cpu(record):
    assert record["failures"] == [], record["failures"]
    assert record["_rc"] == 0, record["_stderr"]
    assert record["device"] == "cpu"


def test_binpack_a_daemon(record):
    a = record["A"]
    assert a["resource"] == const.RESOURCE_NAME
    assert a["devices"] == a["healthy"] == 79
    assert a["node_tpu_count"] in ("1", 1)
    assert json.loads(a["topology_annotation"])["mesh"] == [1, 1, 1]
    assert a["metrics_has_units"]


def test_binpack_b_placement(record):
    b = record["B"]
    assert b["allocated_of"] == [38, 79]
    assert len(b["grants"]) == 5
    for name, g in b["grants"].items():
        assert g["envs"][const.ENV_NVIDIA_VISIBLE_DEVICES] == "0"
        assert g["envs"][const.ENV_HBM_LIMIT_BYTES] == str(g["units"] << 30)
        assert g["annotations"][const.ANN_ASSIGNED_FLAG] == "true"
        assert g["annotations"][const.ANN_RESOURCE_INDEX] == "0"
        assert g["devices"] == ["/dev/accel0"]
    assert sorted(g["units"] for g in b["grants"].values()) == \
        [2, 2, 2, 16, 16]
    assert "38/79 (48%)" in b["inspect"]


def test_binpack_c_tenants(record):
    c = record["C"]
    assert c["streams_equal"]
    assert c["prompt_lengths"] == [16, 511, 1024, 2048]
    for out in c["binpack"].values():
        assert out["rc"] == 0
        assert "NVIDIA_VISIBLE_DEVICES: 0" in out["stdout"]
        assert f"HBM limit: {2 << 30}" in out["stdout"]
    for t in c["tenants"]:
        assert t["rc"] == 0 and t["serve_rc"] == 0 and not t["oom"]
        assert t["grant_bytes"] == 16 << 30 and t["device"] == "cpu"


def test_binpack_d_churn(record):
    d = record["D"]
    assert d["interval_s"] == binpack.CPU_HEALTH_INTERVAL_S
    assert d["control_transitions"] == 0
    assert d["unhealthy_devices"] == 79
    assert d["detect_s"] <= 2 * d["interval_s"] + binpack.OBSERVE_SLACK_S
    assert d["refused_status"] == 503 and d["healthz_while_drained"] == 200
    assert d["served_again"] == 200 and d["equal_to_before"]
    assert [h for _, h in d["transitions"]] == [["Unhealthy"], ["Healthy"]]


def test_binpack_e_sources(record):
    e = record["E"]
    assert e["xid_source"] == "unavailable: no NVML behind this backend"
    assert e["daemon_exit"] == 0 and e["xids_seen"] == []
    assert e["xid_wait_errors"] == 0


def test_manifest_reader_equals_yaml():
    docs = yaml.safe_load_all(Path(binpack.MANIFEST).read_text())
    sts = next(d for d in docs if d["kind"] == "StatefulSet")
    tmpl = sts["spec"]["template"]["spec"]["containers"][0]
    replicas, name, mem, script = binpack.binpack_pods()
    assert (replicas, name, mem, script) == (
        sts["spec"]["replicas"], tmpl["name"],
        tmpl["resources"]["limits"][const.RESOURCE_NAME], tmpl["command"][-1])
    assert (replicas, name, mem) == (3, "binpack-1", 2)
    ported = binpack.port_script(script)
    assert "from tpushare_torch.utils import tenant" in ported
    assert "time.sleep" not in ported and "TPU_" not in ported


def test_binpack_needs_a_card_unless_asked_for_the_cpu():
    # No card visible to the child, also on a host that has one.
    out = _tool(timeout=120, env={"CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 2
    assert "no CUDA card" in out.stderr and out.stdout == ""
