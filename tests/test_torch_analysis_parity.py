"""The port's gate against the JAX package's, rule for rule.

The concurrency, ownership, resource and wire-contract families
(CC201-CC204, TO901/TO902, RL401-RL403, WC301-WC305) are ported as they
stand, together with the layers they stand on (callgraph.py,
threads.py, wire.py). So on the same input both gates must report the
same findings: the same rule on the same line with the same message,
once the package name in it is read the same. This file holds them to
that on every fixture of those families (the JAX package's and the
port's copy) and on the whole of both packages' trees.

The port differs on purpose in two places only, both listed below: the
port's WC301 also knows the card selector ``NVIDIA_VISIBLE_DEVICES``,
and its WC305 names the key list it reads rather than the JAX serving
guide.
"""

import collections
import os

import pytest

from tpushare.analysis import load_config as jax_load_config
from tpushare.analysis import callgraph as jax_callgraph
from tpushare.analysis.engine import all_rules as jax_all_rules
from tpushare.analysis.engine import analyze_file as jax_analyze_file
from tpushare.analysis.rules import concurrency as jax_concurrency
from tpushare_torch.analysis import callgraph, load_config
from tpushare_torch.analysis.engine import (all_rules, analyze_file,
                                            iter_py_files)
from tpushare_torch.analysis.rules import concurrency

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_CONFIG = jax_load_config(root=REPO)
CONFIG = load_config(root=REPO)

#: the rule ids the port carries over unchanged
AS_IS = ("CC201", "CC202", "CC203", "CC204", "TO901", "TO902",
         "RL401", "RL402", "RL403", "WC301", "WC302", "WC303", "WC304",
         "WC305")
#: the fixture families of those rules (file-name prefixes)
AS_IS_FIXTURES = sorted(
    name for name in os.listdir(os.path.join(REPO, "tests", "fixtures",
                                             "torch_analysis"))
    if name.endswith(".py") and name[:2] in ("cc", "to", "rl", "wc"))

#: the port's deliberate wording differences, port -> JAX
PORT_WORDING = {"(wire.NULL_NOT_ZERO_KEYS)": "(docs/SERVING_GUIDE.md)"}
#: the wire literal only the port's WC301 knows
PORT_ONLY_LITERAL = "'NVIDIA_VISIBLE_DEVICES'"


def _rules(registry):
    picked = [r for r in registry() if r.id in AS_IS]
    assert sorted(r.id for r in picked) == sorted(AS_IS)
    return picked


def _norm(message):
    for port, ref in PORT_WORDING.items():
        message = message.replace(port, ref)
    return (message.replace("tpushare_torch/", "tpushare/")
            .replace("tpushare_torch.", "tpushare."))


def _multiset(findings, rel=None):
    return collections.Counter((rel, f.rule, f.line, _norm(f.message))
                               for f in findings)


def test_as_is_fixtures_cover_every_as_is_rule():
    """Every as-is rule has a positive fixture that both gates flag, so
    the parity below is never vacuous for a rule."""
    seen = set()
    rules = _rules(all_rules)
    for name in AS_IS_FIXTURES:
        path = os.path.join(REPO, "tests", "fixtures", "torch_analysis",
                            name)
        seen.update(f.rule for f in analyze_file(
            path, CONFIG, rules=rules, respect_scope=False))
    assert seen == set(AS_IS)


@pytest.mark.parametrize("tree", ["analysis", "torch_analysis"])
@pytest.mark.parametrize("name", AS_IS_FIXTURES)
def test_as_is_rule_fixture_parity(name, tree):
    """The JAX package's fixture and the port's copy of it: both gates
    report the same (rule, line, message) multiset on each."""
    path = os.path.join(REPO, "tests", "fixtures", tree, name)
    ref = _multiset(jax_analyze_file(path, JAX_CONFIG,
                                     rules=_rules(jax_all_rules),
                                     respect_scope=False))
    port = _multiset(analyze_file(path, CONFIG, rules=_rules(all_rules),
                                  respect_scope=False))
    extra = port - ref
    assert ref - port == collections.Counter(), (ref - port, extra)
    assert all(rule == "WC301" and PORT_ONLY_LITERAL in msg
               for _, rule, _, msg in extra), extra


@pytest.mark.parametrize("package", ["tpushare_torch", "tpushare"])
def test_as_is_rule_tree_parity(package, monkeypatch):
    """Over every file of a package, with one call-graph index each and
    scopes off: the CC, TO and RL findings of both gates are equal.
    This holds the ported call graph, thread-role model and dataflow
    summaries to the reference's on real code. CC203 polices whole
    files inside the daemon trees, which each gate names by its own
    package, so both gates are pointed at the trees of ``package``."""
    def daemon_trees(paths):
        return tuple(package + "/" + p.split("/", 1)[1] for p in paths)
    monkeypatch.setattr(jax_concurrency, "CONCURRENCY_PATHS",
                        daemon_trees(jax_concurrency.CONCURRENCY_PATHS))
    monkeypatch.setattr(concurrency, "CONCURRENCY_PATHS",
                        daemon_trees(concurrency.CONCURRENCY_PATHS))
    files = [p for p in iter_py_files([os.path.join(REPO, package)])
             if os.path.basename(p) != "api_pb2.py"]
    jax_rules = [r for r in _rules(jax_all_rules) if r.id[:2] != "WC"]
    rules = [r for r in _rules(all_rules) if r.id[:2] != "WC"]
    jax_project = jax_callgraph.build_index(files, root=REPO)
    project = callgraph.build_index(files, root=REPO)
    ref, port = collections.Counter(), collections.Counter()
    for path in files:
        rel = os.path.relpath(path, REPO)
        ref += _multiset(jax_analyze_file(
            path, JAX_CONFIG, rules=jax_rules, respect_scope=False,
            project=jax_project), rel)
        port += _multiset(analyze_file(
            path, CONFIG, rules=rules, respect_scope=False,
            project=project), rel)
    assert sum(ref.values()) > 0
    assert port == ref, (ref - port, port - ref)


@pytest.mark.parametrize("tree,schedule", [
    ("analysis", "MiniEngine.pick"), ("torch_analysis", "MiniEngine.plan")])
def test_overlap_report_parity(tree, schedule):
    """``--overlap-report``'s model (threads.overlap_report over the call
    graph) is ported as it stands: on the JAX package's overlap fixture
    and the port's, both gates give the same conflict list, field for
    field, access and sites included."""
    from tpushare.analysis import threads as jax_threads
    from tpushare_torch.analysis import threads
    path = os.path.join(REPO, "tests", "fixtures", tree,
                        "to_overlap_engine.py")
    args = (("MiniEngine.tick",), (schedule,))
    names = ("dispatch", "schedule")
    ref = jax_threads.overlap_report(
        jax_callgraph.build_index([path], root=REPO, jobs=1), JAX_CONFIG,
        *args, names=names)
    port = threads.overlap_report(
        callgraph.build_index([path], root=REPO, jobs=1), CONFIG, *args,
        names=names)
    assert len(port["conflicts"]) == 2
    assert port == ref
