"""tpushare_torch.analysis: the port's static-analysis gate — fixture-
proven rules, the whole-tree ratchet over the port, the CLI round trips
and the triage repairs the gate's first run forced (the counterpart of
test_static_analysis.py).

Fast tier on purpose: the analyzer imports nothing but the standard
library. The whole-tree gate here runs the SAME config + baseline as
``python -m tpushare_torch.analysis --check`` — the test and the local
gate cannot drift apart.
"""

import ast
import json
import os
import subprocess
import sys
import textwrap

import pytest

from tpushare_torch.analysis import baseline as baseline_mod
from tpushare_torch.analysis import load_config
from tpushare_torch.analysis.config import parse_proto_messages
from tpushare_torch.analysis.engine import (all_rules, analyze_file,
                                      analyze_paths, parse_suppressions)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_analysis")
CONFIG = load_config(root=REPO)


def rules_of(prefix):
    picked = [r for r in all_rules() if r.id.startswith(prefix)]
    assert picked, f"no rules registered under {prefix}"
    return picked


def run_fixture(name, prefix):
    return analyze_file(os.path.join(FIXTURES, name), CONFIG,
                        rules=rules_of(prefix), respect_scope=False)


# ---------------------------------------------------------------------------
# Fixture-proven true positives, negatives, suppressions — per family
# ---------------------------------------------------------------------------

def test_tracer_safety_positives():
    found = run_fixture("ts_positive.py", "TS101")
    assert len(found) == 5, found
    msgs = " ".join(f.message for f in found)
    for token in ("float() of a tensor", ".item()", ".cpu()", "print()",
                  "time.perf_counter()"):
        assert token in msgs, token
    # the labels name the Function method or the checkpointed def
    assert "ScaledMatmul.forward" in msgs
    assert "ScaledMatmul.backward" in msgs
    assert "checkpointed block()" in msgs
    assert "twice" in msgs


def test_tracer_safety_negatives():
    assert run_fixture("ts_negative.py", "TS101") == []


def test_tracer_safety_suppressed():
    assert run_fixture("ts_suppressed.py", "TS101") == []


def test_autograd_roots_cover_the_ports_functions():
    """The roots TS101/TE701 walk are the port's real autograd bodies:
    the Function subclasses of ops/, parallel/ and models/ and the
    functions the layer loops hand to checkpoint."""
    from tpushare_torch.analysis.rules.tracer_safety import autograd_roots
    labels = {}
    for rel in ("ops/flash_attention.py", "parallel/ring_attention.py",
                "models/transformer.py", "models/moe.py"):
        path = os.path.join(REPO, "tpushare_torch", rel)
        tree = ast.parse(open(path, encoding="utf-8").read())
        labels[rel] = {label for _, label in autograd_roots(tree)}
    assert {"FlashAttentionFn.forward", "FlashAttentionFn.backward"} <= \
        labels["ops/flash_attention.py"]
    assert "RingAttentionFn.backward" in labels["parallel/ring_attention.py"]
    assert "checkpointed block()" in labels["models/transformer.py"]
    assert "_GroupedProducts.forward" in labels["models/moe.py"]


def test_step_loop_sync_positives():
    found = run_fixture("ts103_positive.py", "TS103")
    assert len(found) == 8, found
    msgs = " ".join(f.message for f in found)
    for token in (".cpu()", '.to("cpu")', ".tolist()", ".item()",
                  ".synchronize()", "bool() of a tensor", ".numpy()"):
        assert token in msgs, token
    # Every finding names the offending class.method.
    methods = {f.message.split(" in ")[1].split(" ")[0] for f in found}
    assert methods == {"FakeSlotServer.step", "FakeSlotServer._spec_step",
                       "FakeSlotServer.admit_step",
                       "FakeSlotServer._fused_tick",
                       "FakeSlotServer.step_async",
                       "SpecDecodeMixin._spec_step_async"}


def test_step_loop_sync_negatives():
    assert run_fixture("ts103_negative.py", "TS103") == []


def test_step_loop_sync_suppressed():
    assert run_fixture("ts103_suppressed.py", "TS103") == []


#: the one token fetch of each tick method: suppressed on its line with
#: the cause (the port's one-fetch-per-tick invariant, held statically)
TOKEN_FETCHES = {
    "models/serving.py": ("SlotServer.admit_step", "SlotServer.step_async",
                          "SlotServer._fused_tick_async"),
    "models/paged.py": ("PagedSlotServer.admit_step",
                        "PagedSlotServer.step_async",
                        "PagedSlotServer._fused_tick_async"),
    "models/moe.py": ("MoESlotServer.admit_step",
                      "MoESlotServer._fused_tick_async"),
    "models/spec.py": ("SpecDecodeMixin._spec_step_async",),
}


@pytest.mark.parametrize("rel", sorted(TOKEN_FETCHES))
def test_step_loop_rule_sees_exactly_one_fetch_per_tick(rel, monkeypatch):
    """The servers' token fetch IS a TS103 finding, seen by the rule and
    suppressed on its line with the cause: with suppressions off, each
    tick method shows exactly one sync and nothing else does."""
    from tpushare_torch.analysis import engine
    path = os.path.join(REPO, "tpushare_torch", rel)
    with monkeypatch.context() as m:
        m.setattr(engine, "parse_suppressions", lambda lines: {})
        found = analyze_file(path, CONFIG, rules=rules_of("TS103"))
    ticks = [f.message.split(" in ")[1].split(" ")[0] for f in found]
    assert sorted(ticks) == sorted(TOKEN_FETCHES[rel]), ticks
    for f in found:
        assert "ignore[TS103] the one token fetch" in open(
            path, encoding="utf-8").read().splitlines()[f.line - 1]
    assert analyze_file(path, CONFIG, rules=rules_of("TS103")) == []


def test_swallowed_exception_positives():
    found = run_fixture("cc203_positive.py", "CC203")
    assert len(found) == 5, found
    # Findings name the policed class (scope outside the daemon trees
    # is the serving hot classes only).
    classes = {f.message.split("in ")[1].split(" ")[0] for f in found}
    assert classes == {"FakeSlotServer", "ServeEngineLike"}


def test_swallowed_exception_negatives():
    assert run_fixture("cc203_negative.py", "CC203") == []


def test_swallowed_exception_suppressed():
    assert run_fixture("cc203_suppressed.py", "CC203") == []


def test_swallowed_exception_daemon_tree_is_whole_file():
    """Inside plugin/ the rule polices every function, not just the
    serving classes: the justified pre-existing swallows there are
    baselined, so the rule must keep finding them (a fixed swallow
    leaves a stale baseline entry and the ratchet flags it)."""
    found = analyze_file(os.path.join(REPO, "tpushare_torch", "plugin",
                                      "manager.py"),
                         CONFIG, rules=rules_of("CC203"))
    assert any("daemon-side module" in f.message for f in found)


def test_concurrency_positives():
    found = run_fixture("cc_positive.py", "CC")
    cc201 = [f for f in found if f.rule == "CC201"]
    cc202 = [f for f in found if f.rule == "CC202"]
    # devices+version on the watch thread, devices on the handler; the
    # locked version bump in Allocate must NOT be here.
    assert len(cc201) == 3, found
    assert all("no lock" in f.message for f in cc201)
    assert not any(f.line and "with self._lock" in f.snippet for f in cc201)
    assert len(cc202) == 2, found


def test_concurrency_negatives():
    assert run_fixture("cc_negative.py", "CC") == []


def test_concurrency_suppressed():
    assert run_fixture("cc_suppressed.py", "CC") == []


def test_wire_contract_positives():
    found = run_fixture("wc_positive.py", "WC")
    wc301 = [f for f in found if f.rule == "WC301"]
    wc302 = [f for f in found if f.rule == "WC302"]
    assert len(wc301) == 4, found
    assert {"'TPU_VISIBLE_CHIPS'" in f.message for f in wc301} == {True, False}
    # the port's card selector is a wire literal too
    assert any("'NVIDIA_VISIBLE_DEVICES'" in f.message for f in wc301)
    assert len(wc302) == 3, found
    msgs = " ".join(f.message for f in wc302)
    assert "'wattage'" in msgs          # unknown constructor kwarg
    assert "'BogusMessage'" in msgs     # unknown message
    # unknown attribute on a var assigned from pb.Device(...)
    assert sum("'wattage'" in f.message for f in wc302) == 2


def test_wire_contract_negatives():
    assert run_fixture("wc_negative.py", "WC") == []


def test_wire_contract_suppressed():
    assert run_fixture("wc_suppressed.py", "WC") == []


def test_rl403_positives():
    found = run_fixture("rl403_positive.py", "RL403")
    assert len(found) == 4, found
    assert all(f.rule == "RL403" for f in found)
    msgs = " ".join(f.message for f in found)
    assert "atomicio" in msgs
    # every unsafe mode spelling is named in its own finding
    for mode in ("'w'", "'wb'", "'w+'", "'x'"):
        assert mode in msgs, msgs


def test_rl403_negatives():
    assert run_fixture("rl403_negative.py", "RL403") == []


def test_rl403_suppressed():
    assert run_fixture("rl403_suppressed.py", "RL403") == []


def test_rl403_scoped_to_persistence_modules():
    """The scope IS the 'later re-read across process boundaries'
    approximation: durable/persistence modules only — an engine-local
    tmp file in cli/ is not this rule's business."""
    rule = next(r for r in all_rules() if r.id == "RL403")
    assert rule.applies_to("tpushare_torch/durable/journal.py")
    assert rule.applies_to("tpushare_torch/analysis/baseline.py")
    assert rule.applies_to("tpushare_torch/models/reshard.py")
    assert rule.applies_to("tpushare_torch/utils/checkpoint.py")
    assert not rule.applies_to("tpushare_torch/cli/serve.py")
    # atomicio itself is out of scope: its tmp-write IS the pattern
    assert not rule.applies_to("tpushare_torch/utils/atomicio.py")
    # and the JAX package is not the port's gate's business
    assert not rule.applies_to("tpushare/durable/journal.py")


def test_rl403_seeded_violation_fails_the_gate(tmp_path):
    """A bare open-for-write slipped into a durable module must be a
    NEW finding the baseline does not absorb (the red test)."""
    durable_dir = tmp_path / "tpushare_torch" / "durable"
    durable_dir.mkdir(parents=True)
    bad = durable_dir / "sneaky.py"
    bad.write_text('import json\n'
                   'def save(path, obj):\n'
                   '    with open(path, "w") as f:\n'
                   '        json.dump(obj, f)\n')
    # analyze_file scopes by RELPATH: this fixture lives outside the
    # repo root, so run the rule directly the way the gate would see
    # a real tpushare_torch/durable file.
    rules = [r for r in all_rules() if r.id == "RL403"]
    found = analyze_file(str(bad), CONFIG, rules=rules,
                         respect_scope=False)
    assert len(found) == 1 and found[0].rule == "RL403"
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(found, entries)
    assert len(new) == 1                # nothing baselines it away


def test_rl403_real_tree_is_clean():
    """The pin: every scoped persistence module in the REAL tree
    writes through atomicio, append-only CRC-framed segments, or (the
    checkpoint's streamed save, suppressed on its line with the cause)
    its own tmp + fsync + replace — zero RL403 findings, no baseline
    entries spent on it."""
    rules = [r for r in all_rules() if r.id == "RL403"]
    paths = [CONFIG.resolve(p) for p in CONFIG.paths]
    findings = [f for f in analyze_paths(paths, CONFIG, rules=rules)]
    assert findings == []
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    assert not any(e.get("rule") == "RL403" for e in entries)


def test_checkpoint_save_is_tmp_fsync_replace():
    """The RL403 suppression's cause, held: the streamed save opens a
    tmp name, fsyncs it, and os.replace()s it over the target."""
    src = open(os.path.join(REPO, "tpushare_torch", "utils",
                            "checkpoint.py"), encoding="utf-8").read()
    body = src[src.index("def save("):src.index("def _read_header(")]
    assert "ignore[RL403]" in body
    for step in ('tmp = f"{path}.tmp.', 'open(tmp, "wb")',
                 "os.fsync(f.fileno())", "os.replace(tmp, path)",
                 "atomicio.fsync_dir("):
        assert step in body, step


# ---------------------------------------------------------------------------
# Engine pieces
# ---------------------------------------------------------------------------

def test_suppression_parsing():
    sup = parse_suppressions([
        "x = 1  # tpushare: ignore",
        "y = 2  # tpushare: ignore[TS101]",
        "z = 3  # tpushare: ignore[TS101, WC301]",
        "plain line",
    ])
    assert sup[1] == {"*"}
    assert sup[2] == {"TS101"}
    assert sup[3] == {"TS101", "WC301"}
    assert 4 not in sup


def test_proto_parser_matches_api_proto():
    with open(os.path.join(REPO, CONFIG.proto), encoding="utf-8") as f:
        messages = parse_proto_messages(f.read())
    assert messages["Device"] == {"ID", "health", "topology"}
    assert messages["ContainerAllocateResponse"] == {
        "envs", "mounts", "devices", "annotations", "cdi_devices"}
    assert "devicesIDs" in messages["ContainerAllocateRequest"]
    assert messages["Empty"] == set()


def test_port_proto_is_the_reference_proto():
    """WC302's source of truth is the port's own copy of the v1beta1
    proto: line for line the one its api_pb2 was generated from, up to
    comments."""
    def code(rel):
        text = open(os.path.join(REPO, rel), encoding="utf-8").read()
        return [line.split("//", 1)[0].rstrip()
                for line in text.splitlines()]
    assert CONFIG.proto == "tpushare_torch/deviceplugin/api.proto"
    assert code(CONFIG.proto) == code("tpushare/deviceplugin/api.proto")
    with open(os.path.join(REPO, CONFIG.proto), encoding="utf-8") as f:
        ours = parse_proto_messages(f.read())
    with open(os.path.join(REPO, "tpushare", "deviceplugin", "api.proto"),
              encoding="utf-8") as f:
        assert ours == parse_proto_messages(f.read())


def test_baseline_multiset_matching(tmp_path):
    src = tmp_path / "dup.py"
    src.write_text('A = "TPU_VISIBLE_CHIPS"\nB = "TPU_VISIBLE_CHIPS"\n')
    findings = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    assert len(findings) == 2
    # Both lines strip to different snippets (A=/B=), so one entry
    # matches one finding; the other stays new.
    entries = [{"rule": f.rule, "path": f.path, "snippet": f.snippet}
               for f in findings[:1]]
    new, stale = baseline_mod.diff(findings, entries)
    assert len(new) == 1 and stale == []


def test_listing_tags_agree_with_gate_on_duplicates(tmp_path):
    """Two IDENTICAL violating lines with one baseline entry: the
    informational listing must tag exactly one [baselined] and count
    exactly one new — the same multiset arithmetic the gate enforces."""
    from tpushare_torch.analysis.reporters import render_text
    src = tmp_path / "dup.py"
    src.write_text('X = "TPU_VISIBLE_CHIPS"\nX = "TPU_VISIBLE_CHIPS"\n')
    findings = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    assert len(findings) == 2
    assert findings[0].snippet == findings[1].snippet
    entries = [{"rule": findings[0].rule, "path": findings[0].path,
                "snippet": findings[0].snippet, "note": "x"}]
    new, _ = baseline_mod.diff(findings, entries)
    assert len(new) == 1
    text = render_text(findings, new=new)
    assert text.count("[baselined]") == 1
    assert "2 finding(s), 1 new" in text


# ---------------------------------------------------------------------------
# The whole-tree tier-1 gate (== `python -m tpushare_torch.analysis --check`)
# ---------------------------------------------------------------------------

def _gate():
    paths = [CONFIG.resolve(p) for p in CONFIG.paths]
    findings = analyze_paths(paths, CONFIG)
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    return baseline_mod.diff(findings, entries)


def test_whole_tree_has_no_new_findings():
    new, _stale = _gate()
    assert new == [], (
        "static-analysis regressions (fix, suppress with cause, or "
        "baseline with a justification):\n"
        + "\n".join(f.render() for f in new))


def test_baseline_entries_all_still_exist_and_are_justified():
    """The ratchet only shrinks: every baseline entry must match a
    live finding (else it must be dropped) and carry a note."""
    _new, stale = _gate()
    assert stale == [], ("baseline entries whose violations are gone — "
                         "run --update-baseline: "
                         + json.dumps(stale, indent=1))
    for e in baseline_mod.load(CONFIG.resolve(CONFIG.baseline)):
        assert e.get("note"), f"baseline entry without justification: {e}"


def test_seeded_violation_fails_the_gate(tmp_path):
    """Introducing a raw wire literal anywhere the gate sweeps must
    produce a NEW finding the baseline does not absorb."""
    bad = tmp_path / "sneaky.py"
    bad.write_text('CHIPS_KEY = "TPU_VISIBLE_CHIPS"\n'
                   'IDX = "ALIYUN_COM_TPU_MEM_IDX"\n')
    paths = [CONFIG.resolve(p) for p in CONFIG.paths] + [str(bad)]
    findings = analyze_paths(paths, CONFIG)
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(findings, entries)
    assert {f.rule for f in new} == {"WC301"}
    assert len(new) == 2


def test_cli_check_is_green():
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--jobs", "1"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: no new findings" in proc.stdout


def test_cli_check_fails_on_seeded_violation(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('X = "aliyun.com/tpu-mem"\n')
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check", str(bad)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "WC301" in proc.stdout


def test_cli_check_fails_on_stale_baseline(tmp_path):
    """--check must fail on stale entries too (fixed violations whose
    entries linger) — but with exit code 2 and a prune hint, so CI can
    label 'you fixed something, now prune' apart from 'you broke the
    ratchet' (exit 1)."""
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "WC301", "path": "gone.py",
         "snippet": 'X = "TPU_VISIBLE_CHIPS"', "note": "obsolete"}]}))
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--baseline", str(bl), str(clean)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    assert "stale" in (proc.stdout + proc.stderr)
    assert "--update-baseline" in (proc.stdout + proc.stderr)


def test_cli_check_new_findings_outrank_stale(tmp_path):
    """Both problems at once -> exit 1 (new findings win): the broken
    ratchet is the actionable failure, pruning comes after."""
    bad = tmp_path / "bad.py"
    bad.write_text('X = "TPU_VISIBLE_CHIPS"\n')
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "WC301", "path": "gone.py",
         "snippet": 'Y = "aliyun.com/tpu-mem"', "note": "obsolete"}]}))
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--baseline", str(bl), str(bad)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr


def test_update_baseline_prints_pruned_entries(tmp_path):
    """--update-baseline must say what it dropped — a silently
    shrinking ratchet is unauditable."""
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "WC301", "path": "gone.py",
         "snippet": 'X = "TPU_VISIBLE_CHIPS"', "note": "obsolete"}]}))
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--update-baseline",
         "--baseline", str(bl), str(clean)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "pruned stale entry" in proc.stdout
    assert "WC301" in proc.stdout and "gone.py" in proc.stdout
    assert "1 pruned" in proc.stdout
    assert json.loads(bl.read_text())["entries"] == []


def test_cli_json_output(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('X = "aliyun.com/tpu-mem"\n')
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--json",
         "--no-baseline", str(bad)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0
    payload = json.loads(proc.stdout)
    assert payload["findings"][0]["rule"] == "WC301"
    assert payload["findings"][0]["line"] == 1


# ---------------------------------------------------------------------------
# SARIF reporter (GitHub code-scanning ingestion)
# ---------------------------------------------------------------------------

def test_sarif_render_shape(tmp_path):
    from tpushare_torch.analysis.reporters import render_sarif
    src = tmp_path / "bad.py"
    src.write_text('A = "TPU_VISIBLE_CHIPS"\nB = "aliyun.com/tpu-mem"\n')
    findings = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    assert len(findings) == 2
    # One finding baselined, one new: levels must split note/error.
    entries = [{"rule": findings[0].rule, "path": findings[0].path,
                "snippet": findings[0].snippet, "note": "x"}]
    new, stale = baseline_mod.diff(findings, entries)
    doc = json.loads(render_sarif(findings, new=new, stale=stale,
                                  rules=all_rules()))
    assert doc["version"] == "2.1.0"
    run = doc["runs"][0]
    assert run["tool"]["driver"]["name"] == "tpushare-torch-analysis"
    rule_ids = {r["id"] for r in run["tool"]["driver"]["rules"]}
    assert {"WC301", "TS101", "TS103", "TS104", "RL401", "RL402",
            "CC204", "PK501", "PK502", "DN601", "TE701", "JC801",
            "TO901", "TO902"} <= rule_ids
    results = run["results"]
    assert len(results) == 2
    levels = sorted(r["level"] for r in results)
    assert levels == ["error", "note"]
    for r in results:
        loc = r["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"]
        assert loc["region"]["startLine"] >= 1
        assert r["partialFingerprints"]["tpushareSnippetIdentity/v1"]


def test_sarif_fingerprint_survives_line_drift(tmp_path):
    """The SARIF fingerprint is the baseline identity (rule, path,
    snippet) — moving the violation down the file must not change it,
    so code-scanning alerts track like baseline entries."""
    from tpushare_torch.analysis.reporters import _fingerprint
    src = tmp_path / "drift.py"
    src.write_text('A = "TPU_VISIBLE_CHIPS"\n')
    before = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    src.write_text('# pad\n# pad\nA = "TPU_VISIBLE_CHIPS"\n')
    after = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    assert before[0].line != after[0].line
    assert _fingerprint(before[0]) == _fingerprint(after[0])


def test_cli_sarif_output_file(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text('X = "aliyun.com/tpu-mem"\n')
    out = tmp_path / "analysis.sarif"
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--format", "sarif",
         "--no-baseline", "--output", str(out), str(bad)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    doc = json.loads(out.read_text())
    assert doc["runs"][0]["results"][0]["ruleId"] == "WC301"


# ---------------------------------------------------------------------------
# --diff mode (merge-base narrowing; call graph stays project-wide)
# ---------------------------------------------------------------------------

def _mini_repo(tmp_path):
    """A throwaway git repo laid out as the port's config expects (a
    ``tpushare_torch/`` tree under a pyproject.toml root) so --diff
    tests never depend on this checkout's git state."""
    repo = tmp_path / "mini"
    pkg = repo / "tpushare_torch"
    pkg.mkdir(parents=True)
    (repo / "pyproject.toml").write_text("[project]\nname = 'mini'\n")
    (pkg / "clean.py").write_text("X = 1\n")
    env = dict(os.environ,
               GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")

    def git(*args):
        proc = subprocess.run(["git", *args], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    git("init", "-q", "-b", "main")
    git("add", "-A")
    git("commit", "-qm", "seed")
    return repo, git


def test_diff_mode_flags_only_changed_files(tmp_path):
    repo, git = _mini_repo(tmp_path)
    (repo / "tpushare_torch" / "newbad.py").write_text(
        'X = "TPU_VISIBLE_CHIPS"\n')
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--diff", "HEAD", "--root", str(repo)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "WC301" in proc.stdout
    assert "newbad.py" in proc.stdout


def test_diff_mode_clean_when_nothing_changed(tmp_path):
    repo, _git = _mini_repo(tmp_path)
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--diff", "HEAD", "--root", str(repo)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no analyzed files changed" in proc.stdout


def test_diff_mode_ignores_unrelated_stale_entries(tmp_path):
    """A diff run must scope the ratchet to the changed files: stale
    entries for UNTOUCHED files would otherwise fail every diff run
    (the full run still polices them)."""
    repo, git = _mini_repo(tmp_path)
    bl = repo / "tpushare_torch" / "analysis" / "baseline.json"
    bl.parent.mkdir()
    bl.write_text(json.dumps({
        "version": 1, "entries": [
            {"rule": "WC301", "path": "tpushare_torch/untouched.py",
             "snippet": 'Z = "TPU_VISIBLE_CHIPS"', "note": "elsewhere"}]}))
    (repo / "tpushare_torch" / "touched.py").write_text("Y = 2\n")
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--diff", "HEAD", "--root", str(repo)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_diff_mode_with_subdir_root(tmp_path):
    """git prints diff names relative to the repo TOPLEVEL; when the
    analysis root is a subdirectory (monorepo layout) the paths must
    still resolve — a silent join-onto-root mismatch would empty the
    diff set and wave new violations through."""
    top = tmp_path / "mono"
    sub = top / "proj"
    pkg = sub / "tpushare_torch"
    pkg.mkdir(parents=True)
    (sub / "pyproject.toml").write_text("[project]\nname = 'mono'\n")
    (pkg / "clean.py").write_text("X = 1\n")
    env = dict(os.environ,
               GIT_AUTHOR_NAME="t", GIT_AUTHOR_EMAIL="t@t",
               GIT_COMMITTER_NAME="t", GIT_COMMITTER_EMAIL="t@t")

    def git(*args):
        proc = subprocess.run(["git", *args], cwd=top, env=env,
                              capture_output=True, text=True, timeout=60)
        assert proc.returncode == 0, proc.stderr
        return proc.stdout

    git("init", "-q", "-b", "main")
    git("add", "-A")
    git("commit", "-qm", "seed")
    # One committed-then-modified file and one untracked file: both
    # discovery paths (diff --name-only, ls-files --others) must
    # anchor at the toplevel.
    (pkg / "clean.py").write_text('X = "aliyun.com/tpu-mem"\n')
    (pkg / "newbad.py").write_text('X = "TPU_VISIBLE_CHIPS"\n')
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--diff", "HEAD", "--root", str(sub)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "newbad.py" in proc.stdout and "clean.py" in proc.stdout


def test_diff_mode_agrees_with_full_run_on_changed_files():
    """The CI contract: full-mode findings restricted to a changed
    set == diff-mode findings for that set (the project-wide call
    graph makes the transitive rules see identical context)."""
    changed = [os.path.join(REPO, "tpushare_torch", "models", "paged.py"),
               os.path.join(REPO, "tpushare_torch", "cli", "serve.py")]
    full = analyze_paths([CONFIG.resolve(p) for p in CONFIG.paths],
                         CONFIG)
    narrowed = analyze_paths(
        changed, CONFIG,
        project_paths=[CONFIG.resolve(p) for p in CONFIG.paths])
    changed_rel = {os.path.relpath(p, REPO).replace(os.sep, "/")
                   for p in changed}
    full_scoped = [f for f in full if f.path in changed_rel]
    assert ([f.render() for f in full_scoped]
            == [f.render() for f in narrowed])


# ---------------------------------------------------------------------------
# Baseline ratchet stability (property-style: drift vs. edit)
# ---------------------------------------------------------------------------

def test_ratchet_survives_line_drift_but_not_snippet_edit(tmp_path):
    """The two halves of the snippet-identity contract in one place:
    (a) inserting unrelated lines above a baselined violation changes
    its line number but NOT its identity (no new finding, no stale
    entry); (b) editing the flagged line itself re-flags it as new AND
    strands the old entry as stale."""
    src = tmp_path / "drift.py"
    src.write_text('KEY = "TPU_VISIBLE_CHIPS"\n')
    findings = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    assert len(findings) == 1 and findings[0].line == 1
    entries = [{"rule": f.rule, "path": f.path, "snippet": f.snippet,
                "note": "pinned"} for f in findings]

    # (a) drift: pad five unrelated lines above.
    src.write_text("import os\n\n# filler\nPAD = 1\nMORE = 2\n"
                   'KEY = "TPU_VISIBLE_CHIPS"\n')
    drifted = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    assert drifted[0].line == 6            # the line number DID move
    new, stale = baseline_mod.diff(drifted, entries)
    assert new == [] and stale == []       # ...the identity did not

    # (b) edit the flagged line: same rule, different source text.
    src.write_text("import os\n\n# filler\nPAD = 1\nMORE = 2\n"
                   'RENAMED_KEY = "TPU_VISIBLE_CHIPS"\n')
    edited = analyze_paths([str(src)], CONFIG, rules=rules_of("WC"))
    new, stale = baseline_mod.diff(edited, entries)
    assert len(new) == 1 and len(stale) == 1


# ---------------------------------------------------------------------------
# Wall-time budget: the gate must never become the slow path
# ---------------------------------------------------------------------------

def test_whole_tree_wall_time_under_budget():
    """Full-tree analysis (all rules, inter-procedural index included)
    stays well under the fast-tier budget. Cold-ish measurement: the
    summary caches are cleared first, so this times a real first run,
    not a dict hit. The 30s ceiling is ~20x the observed cost — it
    catches an accidental O(n^2) regression, not scheduler noise."""
    import time
    from tpushare_torch.analysis import callgraph
    callgraph.clear_cache()
    t0 = time.monotonic()
    findings = analyze_paths([CONFIG.resolve(p) for p in CONFIG.paths],
                             CONFIG)
    dt = time.monotonic() - t0
    assert findings is not None
    # The port's tree is ~60k lines: observed ~10 s cold on one core
    # of the CPU host; 30 s catches an O(n^2) regression, not noise.
    assert dt < 30.0, f"whole-tree analysis took {dt:.1f}s"
    # The inter-procedural index must be a memo hit the second time
    # (same files, same mtimes -> the SAME object, no re-extraction):
    # that cache is what keeps repeated gate invocations in one test
    # session from re-paying the link. (Comparing warm vs cold
    # analyze_paths wall time instead is flaky — rule execution and
    # per-file parsing dominate both runs.)
    from tpushare_torch.analysis.engine import iter_py_files
    files = list(iter_py_files([CONFIG.resolve(p) for p in CONFIG.paths],
                               exclude=tuple(CONFIG.exclude)))
    first = callgraph.build_index(files, root=REPO)
    second = callgraph.build_index(files, root=REPO)
    assert first is second


# ---------------------------------------------------------------------------
# --explain: fixture-grounded self-documentation
# ---------------------------------------------------------------------------

def test_every_rule_explains_cleanly():
    """No orphan rules, no fixture drift: every registered rule must
    have positive/negative fixtures, its positive fixture must yield
    at least one finding, its negative must scan clean — enforced by
    running explain() over the whole registry."""
    from tpushare_torch.analysis import ruledoc
    for rule in all_rules():
        text = ruledoc.explain(rule, CONFIG)   # raises on drift
        assert rule.id in text
        assert "positive example" in text
        assert f"# tpushare: ignore[{rule.id}]" in text
        assert rule.description.split()[0] in text


def test_cli_explain_smoke_and_unknown_rule():
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--explain", "PK501"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "PK501" in proc.stdout and "pk_positive.py" in proc.stdout
    assert "# tpushare: ignore[PK501]" in proc.stdout
    bad = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--explain", "XX999"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert bad.returncode == 1
    assert "unknown rule" in bad.stderr


# ---------------------------------------------------------------------------
# Doc-sync: the generated rule table can never drift from the registry
# ---------------------------------------------------------------------------

def test_rule_table_docs_in_sync():
    """The port's table sits in README.md's port section between its
    own markers; the JAX package's table and markers stay as they are,
    and neither of the port's markers contains a JAX marker (the JAX
    doc-sync test reads the first JAX end marker after the JAX begin)."""
    from tpushare.analysis import ruledoc as jax_ruledoc
    from tpushare_torch.analysis import ruledoc
    text = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    embedded = ruledoc.extract_table(text)
    assert embedded is not None, "README.md: PORT RULE TABLE markers missing"
    assert embedded == ruledoc.render_rule_table(), (
        "README.md: the port's rule table drifted from the registry — "
        "regenerate with `python -m tpushare_torch.analysis --rule-table`")
    for ours in (ruledoc.TABLE_BEGIN, ruledoc.TABLE_END):
        for theirs in (jax_ruledoc.TABLE_BEGIN, jax_ruledoc.TABLE_END):
            assert theirs not in ours
    assert jax_ruledoc.extract_table(text) == jax_ruledoc.render_rule_table()


def test_cli_rule_table_round_trip():
    from tpushare_torch.analysis import ruledoc
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--rule-table"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert ruledoc.extract_table(proc.stdout) == ruledoc.render_rule_table()
    text = open(os.path.join(REPO, "README.md"), encoding="utf-8").read()
    assert proc.stdout.strip() in text


def test_rule_table_covers_every_family():
    from tpushare_torch.analysis import ruledoc
    table = ruledoc.render_rule_table()
    for family in ("tracer-safety", "concurrency", "wire-contract",
                   "resource-leak", "generator-discipline", "async-copy",
                   "tensor-escape", "kernel-build", "ownership"):
        assert family in table, family
    for rule in all_rules():
        assert rule.family, f"{rule.id} has no family"
        assert f"| {rule.id} |" in table


# ---------------------------------------------------------------------------
# SARIF per-family category tags
# ---------------------------------------------------------------------------

def test_sarif_rules_carry_family_categories(tmp_path):
    from tpushare_torch.analysis.reporters import render_sarif
    doc = json.loads(render_sarif([], rules=all_rules()))
    metas = doc["runs"][0]["tool"]["driver"]["rules"]
    by_id = {m["id"]: m for m in metas}
    assert by_id["PK501"]["properties"]["category"] == \
        "generator-discipline"
    assert by_id["DN601"]["properties"]["category"] == "async-copy"
    assert by_id["TE701"]["properties"]["category"] == "tensor-escape"
    assert by_id["JC801"]["properties"]["category"] == "kernel-build"
    assert by_id["TO901"]["properties"]["category"] == "ownership"
    assert all(m["properties"]["category"] for m in metas), metas


# ---------------------------------------------------------------------------
# Stale-baseline UX: exit 2 lists the exact stale entries
# ---------------------------------------------------------------------------

def test_cli_stale_exit_lists_exact_entries(tmp_path):
    """The exit-2 message must NAME each stale entry (rule, path,
    snippet) so a CI log is actionable without a local run."""
    clean = tmp_path / "clean.py"
    clean.write_text("X = 1\n")
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"version": 1, "entries": [
        {"rule": "WC301", "path": "gone.py",
         "snippet": 'X = "TPU_VISIBLE_CHIPS"', "note": "obsolete"},
        {"rule": "TS103", "path": "also_gone.py",
         "snippet": "y = x.item()", "note": "old fetch"}]}))
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--baseline", str(bl), str(clean)],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 2, proc.stdout + proc.stderr
    # every entry named with rule, path, AND snippet, on stderr
    assert "stale: WC301 gone.py" in proc.stderr
    assert 'X = "TPU_VISIBLE_CHIPS"' in proc.stderr
    assert "stale: TS103 also_gone.py" in proc.stderr
    assert "y = x.item()" in proc.stderr
    assert "--update-baseline" in proc.stderr


# ---------------------------------------------------------------------------
# --jobs: CLI parity smoke (the engine-level parity test lives in
# tests/test_torch_dataflow.py)
# ---------------------------------------------------------------------------

def test_cli_jobs_flag_green():
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--check",
         "--jobs", "2"],
        cwd=REPO, capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: no new findings" in proc.stdout


# ---------------------------------------------------------------------------
# A seeded violation of each family fails the CLI gate
# ---------------------------------------------------------------------------

#: family -> (repo-relative file the seed lands in, its source, rule)
SEEDS = {
    "tracer-safety": ("tpushare_torch/models/seeded.py", """
        class SeededSlotServer:
            def step(self):
                return self.lengths.cpu()
        """, "TS103"),
    "generator-discipline": ("tpushare_torch/models/seeded.py", """
        import torch

        def noise(x):
            return torch.randn_like(x)
        """, "PK501"),
    "async-copy": ("tpushare_torch/cli/seeded.py", """
        def fetch(t):
            h = t.to("cpu", non_blocking=True)
            return h.tolist()
        """, "DN601"),
    "kernel-build": ("tpushare_torch/ops/seeded.py", """
        import ctypes

        def launch(path):
            return ctypes.CDLL(path).ts_launch()
        """, "JC801"),
    "tensor-escape": ("tpushare_torch/ops/seeded.py", """
        import torch

        class Leaky(torch.autograd.Function):
            @staticmethod
            def forward(ctx, x):
                y = x * 2
                ctx.y = y
                return y
        """, "TE701"),
    "concurrency": ("tpushare_torch/plugin/seeded.py", """
        def poll(fetch):
            try:
                return fetch()
            except Exception:
                pass
        """, "CC203"),
    "ownership": ("tpushare_torch/cli/seeded.py", """
        import threading

        class Engine:
            def __init__(self):
                self.parked = []  # tpushare: owner[engine]
                threading.Thread(target=self._loop).start()
                threading.Thread(target=self._watch).start()

            def _loop(self):
                self.parked = []

            def _watch(self):
                self.parked = [1]
        """, "TO901"),
    "resource-leak": ("tpushare_torch/durable/seeded.py", """
        import json

        def save(path, obj):
            with open(path, "w") as f:
                json.dump(obj, f)
        """, "RL403"),
    "wire-contract": ("tpushare_torch/utils/seeded.py", """
        CARD = "NVIDIA_VISIBLE_DEVICES"
        """, "WC301"),
}


@pytest.mark.parametrize("family", sorted(SEEDS))
def test_seeded_family_violation_fails_the_cli_gate(tmp_path, family):
    """Each family's seeded violation, placed where that family is
    scoped in a port-shaped tree, makes ``--check`` exit 1 naming the
    rule; the same tree without the seed passes."""
    rel, source, rule = SEEDS[family]
    root = tmp_path / "tree"
    (root / "tpushare_torch").mkdir(parents=True)
    (root / "pyproject.toml").write_text("[project]\nname = 'tree'\n")
    (root / "tpushare_torch" / "clean.py").write_text("X = 1\n")
    cmd = [sys.executable, "-m", "tpushare_torch.analysis", "--check",
           "--jobs", "1", "--root", str(root)]
    clean = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                           timeout=120)
    assert clean.returncode == 0, clean.stdout + clean.stderr
    seeded = root / rel
    seeded.parent.mkdir(parents=True, exist_ok=True)
    seeded.write_text(textwrap.dedent(source))
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert rule in proc.stdout, proc.stdout


# ---------------------------------------------------------------------------
# The triage of the port's first run: repairs and the recorded exceptions
# ---------------------------------------------------------------------------

def test_engine_declares_the_serialized_supervisor_handover():
    """The port's engine had dropped the module-level ownership registry
    the reference engine carries: without it the supervisor's writes
    between engine generations (draining, quarantine, the reshard's
    rebuild) read as cross-thread races — four TO901 and five TO902 on
    cli/serve.py. The registry is the reference's, and the engine's
    ownership findings are empty."""
    from tpushare.cli import serve as jserve
    from tpushare_torch.cli import serve as tserve
    assert tserve.TPUSHARE_OWNERSHIP == jserve.TPUSHARE_OWNERSHIP
    found = analyze_file(os.path.join(REPO, "tpushare_torch", "cli",
                                      "serve.py"),
                         CONFIG, rules=rules_of("TO"))
    assert found == [], [f.render() for f in found]


def test_tenant_reads_the_plugins_env_names():
    """The port's tenant spelled the Allocate env it reads as its own
    literals (nine WC301): a renamed constant in plugin/const.py would
    reach the daemon and miss the tenant. It now takes every name from
    const, as the reference's tenant does."""
    from tpushare_torch.plugin import const
    from tpushare_torch.utils import tenant
    found = analyze_file(os.path.join(REPO, "tpushare_torch", "utils",
                                      "tenant.py"),
                         CONFIG, rules=rules_of("WC"))
    assert found == [], [f.render() for f in found]
    for name in ("ENV_NVIDIA_VISIBLE_DEVICES", "ENV_TPU_VISIBLE_CHIPS",
                 "ENV_TPU_VISIBLE_DEVICES", "ENV_RESOURCE_INDEX",
                 "ENV_RESOURCE_BY_POD", "ENV_RESOURCE_BY_CONTAINER",
                 "ENV_RESOURCE_BY_DEV", "ENV_HBM_LIMIT_BYTES",
                 "ENV_HBM_ENFORCE", "ENV_DISABLE_ISOLATION",
                 "ENV_KV_BLOCK_RESERVE", "ENV_KV_BLOCK_LIMIT"):
        assert getattr(tenant, name) == getattr(const, name), name


def test_liaison_counts_and_prints_a_failed_poll(capsys):
    """The gang liaison's watch loop swallowed every failed poll in
    silence (CC203 on cli/serve.py). Over NCCL that loop is what aborts
    a collective blocked on a lost host's ranks, so a poll that kept
    failing left the engine thread hung with nothing to show for it.
    Each failed poll is now counted, the first is printed with the
    count, and the rest at most once per interval."""
    from tpushare_torch.cli import serve as tserve
    from tpushare_torch.models import transformer as tt
    cfg = tt.tiny()
    eng = tserve.ServeEngine(tt.init_params(0, cfg, device="cpu"), cfg,
                             n_slots=2, n_blocks=32, block_size=4,
                             device="cpu")
    polls = []

    def failing_poll():
        polls.append(1)
        if len(polls) == 4:
            eng._stop.set()
        raise ConnectionResetError("liaison socket closed")

    eng._poll_gang = failing_poll
    try:
        eng._liaison_loop()             # returns once _stop is set
    finally:
        eng.stop()
    assert len(polls) == 4
    assert eng._liaison_errors == 4
    err = capsys.readouterr().err
    assert err.count("gang liaison poll failed") == 1, err
    assert "(1 so far)" in err and "liaison socket closed" in err
    found = analyze_file(os.path.join(REPO, "tpushare_torch", "cli",
                                      "serve.py"),
                         CONFIG, rules=rules_of("CC203"))
    assert found == [], [f.render() for f in found]


#: every per-line suppression the port's tree carries: (file, rule)
#: -> count. A new one is a decision to record, not a quiet edit.
SUPPRESSIONS = {
    # the copied journal keeps the reference's own suppression
    ("tpushare_torch/durable/journal.py", "TO901"): 1,
    ("tpushare_torch/models/moe.py", "TS103"): 2,
    ("tpushare_torch/models/paged.py", "TS103"): 3,
    ("tpushare_torch/models/serving.py", "TS103"): 3,
    ("tpushare_torch/models/spec.py", "TS103"): 1,
    ("tpushare_torch/utils/checkpoint.py", "RL403"): 1,
}


def test_suppressions_in_the_tree_are_the_recorded_ones():
    from tpushare_torch.analysis.engine import iter_py_files
    seen = {}
    for path in iter_py_files([CONFIG.resolve(p) for p in CONFIG.paths],
                              exclude=tuple(CONFIG.exclude)):
        rel = os.path.relpath(path, REPO).replace(os.sep, "/")
        if rel.startswith("tpushare_torch/analysis/"):
            continue        # the gate's own docs spell the syntax
        lines = open(path, encoding="utf-8").read().splitlines()
        for rules in parse_suppressions(lines).values():
            for rule in rules:
                seen[(rel, rule)] = seen.get((rel, rule), 0) + 1
    assert seen == SUPPRESSIONS


def test_baseline_is_the_recorded_one():
    """The gate starts with ten baselined findings, each with a note:
    five CC203 the reference baselines on the same lines, the RL402
    alias hand-off the reference baselines too, and four WC301 in the
    measurement tools."""
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    counts = {}
    for e in entries:
        counts[(e["rule"], e["path"])] = counts.get(
            (e["rule"], e["path"]), 0) + 1
        assert len(e["note"]) > 40, e
    assert counts == {
        ("CC203", "tpushare_torch/extender/leader.py"): 1,
        ("CC203", "tpushare_torch/k8s/events.py"): 2,
        ("CC203", "tpushare_torch/plugin/backend.py"): 1,
        ("CC203", "tpushare_torch/plugin/manager.py"): 1,
        ("RL402", "tpushare_torch/models/paged.py"): 1,
        ("WC301", "tpushare_torch/tools/binpack.py"): 2,
        ("WC301", "tpushare_torch/tools/multichip.py"): 1,
        ("WC301", "tpushare_torch/tools/saturation.py"): 1,
    }


# ---------------------------------------------------------------------------
# The boundary: standard library only, and the JAX gate untouched
# ---------------------------------------------------------------------------

def test_gate_imports_nothing_but_the_standard_library():
    """Every module of the gate imports only the standard library and
    its own package (plus the port's stdlib-only atomicio for baseline
    writes), and a run of the CLI loads neither torch nor jax."""
    pkg = os.path.join(REPO, "tpushare_torch", "analysis")
    allowed_prefixes = ("tpushare_torch.analysis",)
    allowed = {"tpushare_torch.utils"}
    for dirpath, _dirs, files in os.walk(pkg):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, fn),
                                  encoding="utf-8").read())
            for node in ast.walk(tree):
                if isinstance(node, ast.ImportFrom) and node.level == 0:
                    mods = [node.module]
                elif isinstance(node, ast.Import):
                    mods = [a.name for a in node.names]
                else:
                    continue
                for mod in mods:
                    top = mod.split(".")[0]
                    if mod.startswith(allowed_prefixes) or mod in allowed:
                        continue
                    assert top in sys.stdlib_module_names, (fn, mod)
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys, tpushare_torch.analysis.__main__ as m; "
         "rc = m.main(['--list-rules']); "
         "print(sorted(k for k in ('torch', 'jax', 'numpy', 'tpushare') "
         "if k in sys.modules))"],
        cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == "[]"


def test_jax_gate_config_and_baseline_untouched():
    """The port adds no [tool.tpushare-analysis] keys and no JAX
    baseline entry: the JAX gate still reads its own 30."""
    from tpushare.analysis import baseline as jax_baseline
    from tpushare.analysis import load_config as jax_load_config
    jcfg = jax_load_config(root=REPO)
    assert not any(p.startswith("tpushare_torch") for p in jcfg.paths)
    assert len(jax_baseline.load(jcfg.resolve(jcfg.baseline))) == 30
    assert CONFIG.paths == ("tpushare_torch", "chip_smoke.py")
    assert CONFIG.baseline == "tpushare_torch/analysis/baseline.json"


def test_cli_check_fails_on_a_baseline_entry_without_a_note(tmp_path):
    """Every baseline entry carries its cause: an entry whose finding is
    live but whose note is empty fails --check (exit 1), naming it."""
    bad = tmp_path / "bad.py"
    bad.write_text('X = "TPU_VISIBLE_CHIPS"\n')
    bl = tmp_path / "baseline.json"
    for note, rc in (("", 1), ("deliberate: a fixture", 0)):
        bl.write_text(json.dumps({"version": 1, "entries": [
            {"rule": "WC301", "path": str(bad).replace(os.sep, "/"),
             "snippet": 'X = "TPU_VISIBLE_CHIPS"', "note": note}]}))
        proc = subprocess.run(
            [sys.executable, "-m", "tpushare_torch.analysis", "--check",
             "--baseline", str(bl), str(bad)],
            cwd=REPO, capture_output=True, text=True, timeout=120)
        assert proc.returncode == rc, proc.stdout + proc.stderr
        if rc:
            assert "no note: WC301" in proc.stderr


# ---------------------------------------------------------------------------
# Overlap report: golden fixture + the port engine's committed artifact
# ---------------------------------------------------------------------------

OVERLAP_ARTIFACT = os.path.join("tpushare_torch", "analysis",
                                "overlap_baseline.json")


def _fixture_index(name):
    from tpushare_torch.analysis import callgraph
    return callgraph.build_index([os.path.join(FIXTURES, name)], root=REPO,
                                 jobs=1)


def test_overlap_golden():
    """The port's miniature overlapped tick: dispatch (``tick``) runs the
    plan after its step, so the plan's write shows on both sides; the
    ledger is debited by dispatch and read by the plan. Read/read
    (``queue``, ``limits``) and one-sided fields stay out."""
    from tpushare_torch.analysis import threads
    report = threads.overlap_report(
        _fixture_index("to_overlap_engine.py"), CONFIG,
        ("MiniEngine.tick",), ("MiniEngine.plan",),
        names=("dispatch", "schedule"))
    by = {c["field"]: c for c in report["conflicts"]}
    assert list(by) == ["MiniEngine.plan_cell", "MiniLedger.used"], report
    assert by["MiniEngine.plan_cell"]["dispatch_access"] == "write"
    assert by["MiniEngine.plan_cell"]["schedule_access"] == "write"
    assert by["MiniLedger.used"]["dispatch_access"] == "read+write"
    assert by["MiniLedger.used"]["schedule_access"] == "read"
    for field in ("MiniEngine.queue", "MiniLedger.limits",
                  "MiniEngine.slots", "MiniEngine.counters"):
        assert field not in by


def test_overlap_unresolved_entries_reported():
    from tpushare_torch.analysis import threads
    report = threads.overlap_report(
        _fixture_index("to_overlap_engine.py"), CONFIG,
        ("MiniEngine.tick",), ("NoSuch.method",))
    assert report["b"]["unresolved"] == ["NoSuch.method"]
    assert report["b"]["resolved"] == []


def test_overlap_surfaces_resolve_on_the_port():
    """Every named surface entry is a method of the port's engine, its
    scheduler or its quota: none resolves to nothing."""
    from tpushare_torch.analysis import callgraph, threads
    from tpushare_torch.analysis.engine import iter_py_files
    files = sorted(iter_py_files([CONFIG.resolve(p) for p in CONFIG.paths],
                                 exclude=CONFIG.exclude))
    index = callgraph.build_index(files, root=CONFIG.root, jobs=1)
    for name, specs in threads.DEFAULT_SURFACES.items():
        found, missing = threads.resolve_entries(index, specs)
        assert missing == [], (name, missing)
        assert all(f.relpath.startswith("tpushare_torch/") for f in found)


def test_overlap_artifact_every_entry_justified():
    with open(os.path.join(REPO, OVERLAP_ARTIFACT), encoding="utf-8") as f:
        artifact = json.load(f)
    assert artifact["conflicts"], "empty artifact — regenerate it"
    for c in artifact["conflicts"]:
        assert c.get("justification", "").strip(), (
            f"overlap on {c.get('field')} committed without a "
            f"justification — every shared field needs a written story")
        assert "tpushare/" not in " ".join(
            c["tick-dispatch_sites"] + c["tick-schedule_sites"])


def test_overlap_cli_gate_green_against_committed_artifact():
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis",
         "--overlap-report", "tick-dispatch", "tick-schedule",
         "--overlap-baseline", OVERLAP_ARTIFACT, "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    report = json.loads(proc.stdout)
    assert report["conflicts"], "surfaces no longer overlap?"
    assert "justified" in proc.stderr


def test_overlap_cli_gate_fails_on_unjustified_conflict(tmp_path):
    empty = tmp_path / "overlap_baseline.json"
    empty.write_text(json.dumps({"conflicts": []}))
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis",
         "--overlap-report", "tick-dispatch", "tick-schedule",
         "--overlap-baseline", str(empty), "--format", "json"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stderr
    assert "new overlap" in proc.stderr


@pytest.mark.parametrize("fmt", ["text", "sarif"])
def test_overlap_renderings(fmt):
    """Text names each field with both sides' access; sarif carries one
    TO900 note per conflict, located at its first dispatch-side site."""
    from tpushare_torch.analysis import threads
    names = ("dispatch", "schedule")
    report = threads.overlap_report(
        _fixture_index("to_overlap_engine.py"), CONFIG,
        ("MiniEngine.tick",), ("MiniEngine.plan",), names=names)
    if fmt == "text":
        text = threads.render_overlap_text(report, names=names)
        assert "MiniLedger.used: dispatch=read+write schedule=read" in text
        assert text.endswith("2 overlapping field(s)")
    else:
        doc = threads.render_overlap_sarif(report, names=names)
        results = doc["runs"][0]["results"]
        assert [r["ruleId"] for r in results] == ["TO900", "TO900"]
        loc = results[1]["locations"][0]["physicalLocation"]
        assert loc["artifactLocation"]["uri"].endswith(
            "torch_analysis/to_overlap_engine.py")
        assert loc["region"]["startLine"] == 20


# ---------------------------------------------------------------------------
# Doc-sync: the port's /stats tables are generated, byte for byte
# ---------------------------------------------------------------------------

WIRE_DOC = os.path.join(REPO, "docs", "torch", "SERVING_WIRE.md")


@pytest.fixture(scope="module")
def port_wire_index():
    from tpushare_torch.analysis import callgraph, wire
    from tpushare_torch.analysis.engine import iter_py_files
    files = sorted(iter_py_files([CONFIG.resolve(p) for p in CONFIG.paths],
                                 exclude=CONFIG.exclude))
    index = callgraph.build_index(files, root=CONFIG.root, jobs=1)
    return index, wire.build(index, CONFIG)


def test_wire_table_doc_in_sync(port_wire_index):
    from tpushare_torch.analysis import wire
    doc = open(WIRE_DOC, encoding="utf-8").read()
    embedded = wire.extract_table(doc)
    assert embedded is not None, "WIRE TABLE markers missing"
    assert embedded == wire.table_block(port_wire_index[1]), (
        "docs/torch/SERVING_WIRE.md drifted from the extractor — "
        "regenerate with `python -m tpushare_torch.analysis --wire-table`")


def test_wire_table_cli_matches_library(port_wire_index):
    from tpushare_torch.analysis import wire
    proc = subprocess.run(
        [sys.executable, "-m", "tpushare_torch.analysis", "--wire-table"],
        cwd=REPO, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout == wire.table_block(port_wire_index[1])


def test_wire_table_is_deterministic(port_wire_index):
    from tpushare_torch.analysis import wire
    index, _ = port_wire_index
    a = wire.table_block(wire.build(index, CONFIG))
    b = wire.table_block(wire.build(index, CONFIG))
    assert a == b
    assert a.startswith(wire.TABLE_BEGIN)
    assert a.rstrip("\n").endswith(wire.TABLE_END)


def test_wire_table_holds_the_engines_keys(port_wire_index):
    """The engine's table is the port's own: its handler resolves to the
    keys ``ServeEngine.stats`` produces (the one-fetch counter, the
    overlapped tick's host gap, the null-contract pool keys), each
    produced in ``tpushare_torch/cli/serve.py``, and its markers are not
    the JAX serving guide's."""
    from tpushare.analysis import wire as jax_wire
    from tpushare_torch.analysis import wire
    block = wire.table_block(port_wire_index[1])
    engine = block.split("**Router")[0]
    for key in ("fetches_per_tick", "host_gap_ms", "free_blocks",
                "queue_depth", "pipeline_flushes"):
        row = next(l for l in engine.splitlines()
                   if l.startswith(f"| `{key}` |"))
        assert "`tpushare_torch/cli/serve.py:" in row, row
    assert "`tpushare/" not in block
    assert wire.TABLE_BEGIN != jax_wire.TABLE_BEGIN


def test_wire_follows_a_returned_self_helper(tmp_path):
    """``return self._helper()`` hands the helper's dict shape to the
    method (the engine's ``stats`` returns ``_stats_locked`` under its
    lock); a helper of another receiver is not followed."""
    from tpushare_torch.analysis import callgraph, wire
    (tmp_path / "eng.py").write_text(
        "import threading\n"
        "class Eng:\n"
        "    def __init__(self):\n"
        "        self._lock = threading.Lock()\n"
        "        self.other = None\n"
        "    def stats(self):\n"
        "        with self._lock:\n"
        "            return self._stats_locked()\n"
        "    def _stats_locked(self):\n"
        "        return {'a': 1, 'b': None if self.other else 2}\n"
        "    def elsewhere(self):\n"
        "        return self.other.stats()\n")
    index = callgraph.build_index([str(tmp_path / "eng.py")],
                                  root=str(tmp_path), jobs=1)
    res = wire._Resolver(index)
    shape = res.func_shape("eng.py::Eng.stats")
    assert shape is not None and not shape.open
    assert sorted(shape.keys) == ["a", "b"]
    assert shape.keys["a"].types == {"int"} and shape.keys["b"].nullable
    assert shape.keys["a"].site == ("eng.py", 10)
    assert res.func_shape("eng.py::Eng.elsewhere") is None
