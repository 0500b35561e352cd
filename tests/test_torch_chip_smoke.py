"""chip_smoke.py's own plumbing, on the host: the side-by-side runner of
the subprocess phases, whole-line output from threads, the flex phase's
compile apart from its timing, and the MoE checkpoint's cut."""

import functools
import json
import os
import subprocess
import sys
import threading

import pytest
import torch

import chip_smoke

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class TestSideBySide:
    def test_runs_each_function_at_once_and_returns_in_order(self):
        # Each of the three waits until all three have started: run one
        # after another, they would time out.
        gate = threading.Barrier(3, timeout=10)

        def fn(x):
            gate.wait()
            return x, threading.get_ident()

        got = chip_smoke.side_by_side(*(functools.partial(fn, i)
                                        for i in range(3)))
        assert [x for x, _ in got] == [0, 1, 2]
        assert got[0][1] == threading.get_ident()     # the first, here
        assert len({t for _, t in got}) == 3

    def test_raises_the_first_error_after_every_function_ended(self):
        ended = []

        def slow():
            threading.Event().wait(0.2)
            ended.append("slow")

        def bad():
            raise ValueError("planted")

        with pytest.raises(ValueError, match="planted"):
            chip_smoke.side_by_side(bad, slow)
        assert ended == ["slow"]


def test_emit_writes_whole_lines_from_threads():
    """Lines far longer than a pipe's atomic write, from four threads at
    once, come out whole."""
    code = (
        "import threading, chip_smoke\n"
        "def go(i):\n"
        "    for j in range(20):\n"
        "        chip_smoke.emit({'t': i, 'j': j, 'pad': str(i) * 20000})\n"
        "ts = [threading.Thread(target=go, args=(i,)) for i in range(4)]\n"
        "[t.start() for t in ts]; [t.join() for t in ts]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    rows = [json.loads(line) for line in out.splitlines()]
    assert len(rows) == 80
    assert all(r["pad"] == str(r["t"]) * 20000 for r in rows)
    for i in range(4):
        assert [r["j"] for r in rows if r["t"] == i] == list(range(20))


def test_flex_compiles_apart_from_its_timing(monkeypatch):
    """compile_flex_later makes each queued call's first call; the flex
    phase then only times it, and still compiles what was not."""
    calls = []

    def fake_library(name):
        calls.append(("compile", name))

        def timer():
            calls.append(("time", name))
            return 1.0, 0.0, 2.0, None
        return timer

    monkeypatch.setattr(chip_smoke, "flex_library", fake_library)
    monkeypatch.setattr(chip_smoke, "FLEX_LATER", [])
    monkeypatch.setattr(chip_smoke, "emit", lambda obj: None)
    rows = [{"kernel": "k", "case": c} for c in ("a", "b")]
    chip_smoke.flex_later(rows[0], "a")
    chip_smoke.compile_flex_later()
    chip_smoke.flex_later(rows[1], "b")
    assert calls == [("compile", "a")]
    chip_smoke.run_flex_later()
    assert calls == [("compile", "a"), ("time", "a"), ("compile", "b"),
                     ("time", "b")]
    assert chip_smoke.FLEX_LATER == []
    for r in rows:
        assert (r["library_ms"], r["flex_compile_s"]) == (1.0, 2.0)


def test_checkpoint_cut_keeps_the_first_layer_and_expert():
    L, E, D, F = 2, 4, 3, 5
    leaf = {"wq": torch.randn(L, D, D), "router": torch.randn(L, D, E),
            **{n: torch.randn(L, E, D, F) for n in chip_smoke.EXPERT_LEAVES}}
    tree = {"embed": torch.randn(7, D), "layers": leaf}
    state = {"m": tree, "v": tree}
    cut = chip_smoke.first_layer(state)
    for part in ("m", "v"):
        assert cut[part]["embed"] is tree["embed"]
        got = cut[part]["layers"]
        assert got["wq"].shape == (1, D, D)
        assert got["router"].shape == (1, D, E)
        for n in chip_smoke.EXPERT_LEAVES:
            assert got[n].shape == (1, 1, D, F)
            assert got[n].is_contiguous()
            assert torch.equal(got[n][0, 0], leaf[n][0, 0])
