"""BENCHMARK.json against the contract's shapes, and every cell against
the files the harness finds by name."""

import json
import os
import re

import pytest

from portbench import harness

BENCH = harness.load_json(os.path.join(harness.ROOT, "BENCHMARK.json"))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
WIDTH_WORDS = ("hidden", "intermediate", "head", "latent", "state",
               "expert", "_dim", "_rank", "per_tok")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"][1] == "portbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = harness.resolve(cell)
    assert c.workload["chips"] == 1
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    # Each per-layer metric moves an end-to-end metric its cells report.
    assert all(m["moves"] in names for m in c.per_layer)
    assert c.limits["compare"] and all(
        float(v) > 0 for v in c.limits["compare"].values())
    assert c.limits["sample_tokens"] >= 256
    assert hasattr(c.family, "Model")


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_has_reader(metric):
    mod = harness.load_file(
        os.path.join(harness.PB, "metrics", metric + ".py"), "m")
    assert callable(mod.read)


def test_names_and_units():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS]
             + [w["traffic"] for w in BENCH["workloads"]]
             + [w["config"] for w in BENCH["workloads"]]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        assert len({x["name"] for x in group}) == len(group)
    for m in METRICS:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_per_layer_fields():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        if "roofline" in m["name"]:
            assert m["name"].endswith("_roofline"), m["name"]
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    # Wherever a kernel roofline moves a metric, a step MFU moves it too.
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in o["name"] and o["moves"] == m["moves"]
                       and set(m["workloads"]) <= set(o["workloads"])
                       for o in BENCH["per_layer"]), m["name"]


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert 1 <= len(conf["why"]) <= 200 and "\n" not in conf["why"]
    path = os.path.join(harness.ROOT, conf["file"])
    assert conf["file"].startswith("portbench/")
    body = harness.load_json(path)
    assert body["source"] == conf["source"]
    assert body["reduced"] == conf["reduced"]
    for k in conf["reduced"]:
        assert not any(w in k for w in WIDTH_WORDS), k
    for k in ("hidden_size", "num_hidden_layers", "num_attention_heads",
              "num_key_value_heads", "intermediate_size", "vocab_size"):
        assert isinstance(body[k], int)


def test_paths_hold_only_names_of_allowed_characters():
    for base, dirs, files in os.walk(harness.PB):
        dirs[:] = [d for d in dirs if d not in ("__pycache__", "_cache")]
        for f in files + dirs:
            assert re.match(r"^[A-Za-z0-9_.-]+$", f), f
