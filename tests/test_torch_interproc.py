"""The port's inter-procedural analysis layer: call graph, summaries,
and the TS104 / RL401 / RL402 / CC204 rule families (the counterpart of
test_interproc_analysis.py).

Fast tier: tpushare_torch.analysis imports nothing but the standard
library. Fixture tests prove each family's positive/negative/
suppressed behavior; the red tests prove a SEEDED violation with
helper indirection at depth >= 2 — i.e. structurally invisible to any
intra-function rule — is caught and not absorbed by the baseline; the
engine-shape test pins that the orphaned-slot admission path yields an
RL401.
"""

import os
import textwrap

from tpushare_torch.analysis import baseline as baseline_mod
from tpushare_torch.analysis import callgraph
from tpushare_torch.analysis import load_config
from tpushare_torch.analysis.engine import all_rules, analyze_file

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


def run_source(tmp_path, source, prefix, name="seeded.py"):
    src = tmp_path / name
    src.write_text(textwrap.dedent(source))
    return analyze_file(str(src), CONFIG, rules=rules_of(prefix),
                        respect_scope=False)


# ---------------------------------------------------------------------------
# TS104 — transitive host sync
# ---------------------------------------------------------------------------

def test_ts104_positives():
    found = run_fixture("ts104_positive.py", "TS104")
    assert len(found) == 3, found
    msgs = " ".join(f.message for f in found)
    assert ".tolist()" in msgs and ".numpy()" in msgs
    # Every finding names the entry, the chain, and the depth.
    assert all("via" in f.message and "depth" in f.message
               for f in found)
    # The two-hop chain is reported with both intermediate frames.
    assert "_retire -> FakeSlotServer._mirror" in msgs
    entries = {f.message.split(" reached from ")[1].split(" via ")[0]
               for f in found}
    assert entries == {"FakeSlotServer.step", "FakeSlotServer._spec_step"}


def test_ts104_negatives():
    assert run_fixture("ts104_negative.py", "TS104") == []


def test_ts104_suppressed():
    assert run_fixture("ts104_suppressed.py", "TS104") == []


def test_ts104_does_not_duplicate_ts103_direct_syncs():
    """A sync written directly in a step-loop body is TS103's finding;
    TS104 must stay silent on it (no double-report, no double
    baseline entry)."""
    found = analyze_file(os.path.join(FIXTURES, "ts103_positive.py"),
                         CONFIG, rules=rules_of("TS104"),
                         respect_scope=False)
    assert found == []


def test_ts104_red_seeded_depth3_not_absorbed_by_baseline(tmp_path):
    """Red test: a seeded sync THREE frames below step() is caught,
    and the checked-in baseline absorbs none of it."""
    found = run_source(tmp_path, """
        class SneakySlotServer:
            def step(self):
                return self._a()

            def _a(self):
                return self._b()

            def _b(self):
                return self._c()

            def _c(self):
                return self.buf.cpu()
        """, "TS104")
    assert len(found) == 1
    assert "depth 3" in found[0].message
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(found, entries)
    assert len(new) == 1


def test_ts104_real_tree_tick_is_sync_free_below_its_body():
    """The port's servers keep the whole tick call tree sync-free: the
    one token fetch is written in the tick bodies (TS103, suppressed
    with its cause), and no helper below them waits on the card — so
    TS104 is clean on every server module with no baseline entry."""
    for rel in ("models/paged.py", "models/serving.py", "models/moe.py",
                "models/spec.py"):
        found = analyze_file(os.path.join(REPO, "tpushare_torch", rel),
                             CONFIG, rules=rules_of("TS104"))
        assert found == [], [f.render() for f in found]
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    assert not any(e["rule"] == "TS104" for e in entries)


# ---------------------------------------------------------------------------
# RL401 / RL402 — resource-leak regions
# ---------------------------------------------------------------------------

def test_rl_positives():
    found = run_fixture("rl_positive.py", "RL")
    rl401 = [f for f in found if f.rule == "RL401"]
    rl402 = [f for f in found if f.rule == "RL402"]
    assert len(rl401) == 2, found
    assert len(rl402) == 1, found
    msgs = " ".join(f.message for f in rl401)
    assert "may raise" in msgs            # the escaping-exception case
    assert "neither released nor handed off" in msgs   # the plain leak
    assert "orphans the slot" in rl401[0].message
    assert "block allocation" in rl402[0].message


def test_rl_negatives():
    assert run_fixture("rl_negative.py", "RL") == []


def test_rl_suppressed():
    assert run_fixture("rl_suppressed.py", "RL") == []


def test_rl401_red_seeded_depth2_not_absorbed_by_baseline(tmp_path):
    """Red test: the raise is two helper frames below the escaping
    call — intra-function analysis sees a plain method call; only the
    propagated may-raise summary exposes the leak edge."""
    found = run_source(tmp_path, """
        class LeakyEngine:
            def admit_one(self, req):
                slot = self.srv.admit(req.prompt)
                self._register(slot, req)
                self._active[slot] = req

            def _register(self, slot, req):
                self._validate(req)

            def _validate(self, req):
                if req.bad:
                    raise RuntimeError("boom")
        """, "RL401")
    assert len(found) == 1
    assert found[0].rule == "RL401"
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(found, entries)
    assert len(new) == 1


def test_rl401_catches_orphaned_slot_shape():
    """Acceptance pin: the ServeEngine admit-failure-after-activation
    shape a human review once had to catch yields an RL401 — the rule
    demonstrably catches the bug class that previously required a
    human review."""
    found = run_fixture("rl401_engine_shape.py", "RL401")
    assert len(found) == 1, found
    f = found[0]
    assert f.rule == "RL401"
    assert "_first_token" in f.message      # the escaping fallible step
    assert "slot" in f.message
    # It anchors between activation and registration, not at either.
    assert "self._first_token(slot, req)" in f.snippet


def test_rl_guard_shapes_are_recognized(tmp_path):
    """_safe_evict in an except handler and a finally-release both
    close the region (the fix shapes must scan clean)."""
    found = run_source(tmp_path, """
        class FixedEngine:
            def admit_one(self, req):
                slot = self.srv.admit(req.prompt)
                try:
                    self._register(slot, req)
                except Exception:
                    self._safe_evict(slot)
                    raise
                self._active[slot] = req

            def admit_two(self, req):
                slot = self.srv.admit(req.prompt)
                try:
                    self._register(slot, req)
                finally:
                    self.srv.evict(slot)

            def _safe_evict(self, slot):
                self.srv.evict(slot)

            def _register(self, slot, req):
                if req.bad:
                    raise RuntimeError("boom")
        """, "RL")
    assert found == []


def test_rl401_escape_not_hidden_by_unrelated_store(tmp_path):
    """A fallible call that stores one of its OWN arguments must not
    exempt itself from the escape check for OTHER held handles — only
    the names a call disposes of are safe."""
    found = run_source(tmp_path, """
        class E:
            def admit(self, req, extra):
                slot = self.srv.admit(req.prompt)
                self._record(extra)
                self._active[slot] = req

            def _record(self, extra):
                self.log.append(extra)
                if extra:
                    raise RuntimeError("x")
        """, "RL401")
    assert len(found) == 1
    assert "'slot'" in found[0].message


# ---------------------------------------------------------------------------
# CC204 — lock-order inversion
# ---------------------------------------------------------------------------

def test_cc204_positives():
    found = run_fixture("cc204_positive.py", "CC204")
    assert len(found) == 2, found
    msgs = " ".join(f.message for f in found)
    assert "lock-order inversion" in msgs
    assert "re-acquired while already held" in msgs
    # Each cycle is reported ONCE, with both edge sites in the message.
    inv = [f for f in found if "inversion" in f.message][0]
    assert inv.message.count("->") >= 2
    assert "_lock" in inv.message and "_pool_lock" in inv.message


def test_cc204_negatives():
    assert run_fixture("cc204_negative.py", "CC204") == []


def test_cc204_suppressed():
    assert run_fixture("cc204_suppressed.py", "CC204") == []


def test_cc204_red_seeded_depth2_chain(tmp_path):
    """Red test: the inversion is only visible through two-deep call
    chains on BOTH sides — no single function nests the locks at
    all."""
    found = run_source(tmp_path, """
        import threading

        class DeepEngine:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def tick(self):
                with self._a:
                    self._h1()

            def _h1(self):
                self._h2()

            def _h2(self):
                with self._b:
                    pass

            def stats(self):
                with self._b:
                    self._g1()

            def _g1(self):
                self._g2()

            def _g2(self):
                with self._a:
                    pass
        """, "CC204")
    assert len(found) == 1
    assert "inversion" in found[0].message
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(found, entries)
    assert len(new) == 1


def test_cc204_cycle_anchored_in_policed_file(tmp_path):
    """A cycle whose globally-earliest edge sits in an OUT-OF-SCOPE
    file must anchor at its earliest IN-SCOPE edge instead — anchored
    out of scope, check() would never run on that file and the
    deadlock would be reported nowhere."""
    # 'aaa/helper.py' sorts before 'tpushare_torch/plugin/x.py', so the
    # naive global-min anchor would land out of scope.
    scoped = tmp_path / "tpushare_torch" / "plugin" / "x.py"
    unscoped = tmp_path / "aaa" / "helper.py"
    scoped.parent.mkdir(parents=True)
    unscoped.parent.mkdir(parents=True)
    # Lock identity is Class.attr, so the same class name in both
    # files (a subclass/extension shape) makes the edges meet on the
    # same two lock nodes.
    scoped.write_text(textwrap.dedent("""
        import threading

        class P:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def one(self):
                with self._a:
                    with self._b:
                        pass
        """))
    unscoped.write_text(textwrap.dedent("""
        import threading

        class P:
            def __init__(self):
                self._a = threading.Lock()
                self._b = threading.Lock()

            def two(self):
                with self._b:
                    with self._a:
                        pass
        """))
    index = callgraph.build_index([str(scoped), str(unscoped)],
                                  root=str(tmp_path))
    cfg = load_config(root=str(tmp_path))
    found = analyze_file(str(scoped), cfg, rules=rules_of("CC204"),
                         project=index)
    assert len(found) == 1, found
    assert found[0].path.endswith("tpushare_torch/plugin/x.py")


def test_cc204_real_tree_is_clean():
    """The shipping daemon/engine currently has NO lock-order cycles
    (plugin/server.py deliberately snapshots under one lock at a time,
    serve.py's _pop_lock guards a pop handoff with no nested
    acquisition). This pin is the alarm wire: a cycle appearing
    anywhere in the policed trees is a new finding, not churn."""
    for rel in ("tpushare_torch/cli/serve.py",
                "tpushare_torch/plugin/server.py",
                "tpushare_torch/k8s/watch.py",
                "tpushare_torch/chaos/injector.py"):
        found = analyze_file(os.path.join(REPO, rel), CONFIG,
                             rules=rules_of("CC204"))
        assert found == [], [f.render() for f in found]


# ---------------------------------------------------------------------------
# Call-graph / summary unit coverage
# ---------------------------------------------------------------------------

def _index_for(tmp_path, source, name="mod.py"):
    src = tmp_path / name
    src.write_text(textwrap.dedent(source))
    return callgraph.build_index([str(src)]), str(src)


def test_callgraph_resolves_self_and_attr_types(tmp_path):
    index, path = _index_for(tmp_path, """
        class Server:
            def work(self):
                pass

        class Engine:
            def __init__(self):
                self.srv = Server()

            def run(self):
                self.helper()
                self.srv.work()

            def helper(self):
                pass
        """)
    run = index.func(f"{path}::Engine.run")
    resolved = {q for c in run.calls for q in c.resolved}
    assert f"{path}::Engine.helper" in resolved
    assert f"{path}::Server.work" in resolved


def test_callgraph_duck_resolves_srv_onto_slotserver_family(tmp_path):
    """self.srv with no __init__ assignment in view falls back onto
    the *SlotServer family — the ServeEngine adapter seam."""
    index, path = _index_for(tmp_path, """
        class PagedSlotServer:
            def evict(self, slot):
                raise RuntimeError("boom")

        class Engine:
            def run(self):
                self.srv.evict(0)
        """)
    run = index.func(f"{path}::Engine.run")
    resolved = {q for c in run.calls for q in c.resolved}
    assert f"{path}::PagedSlotServer.evict" in resolved


def test_may_raise_propagates_and_respects_try(tmp_path):
    index, path = _index_for(tmp_path, """
        def leaf():
            raise ValueError("x")

        def mid():
            leaf()

        def guarded():
            try:
                leaf()
            except ValueError:
                return None

        def handled():
            try:
                raise ValueError("x")
            except ValueError:
                return None

        def rethrower():
            try:
                pass
            except ValueError:
                raise RuntimeError("worse")

        def top():
            mid()
        """)
    assert index.func(f"{path}::leaf").may_raise
    assert index.func(f"{path}::mid").may_raise
    assert index.func(f"{path}::top").may_raise
    assert not index.func(f"{path}::guarded").may_raise
    # A raise the function itself catches is not may-raise (it would
    # flood RL4xx with false escape edges)...
    assert not index.func(f"{path}::handled").may_raise
    # ...but a raise IN a handler leaves the frame and is.
    assert index.func(f"{path}::rethrower").may_raise


def test_trans_locks_fixpoint(tmp_path):
    index, path = _index_for(tmp_path, """
        import threading

        class C:
            def __init__(self):
                self._lock = threading.Lock()

            def outer(self):
                self.inner()

            def inner(self):
                with self._lock:
                    pass
        """)
    assert index.func(f"{path}::C.outer").trans_locks == {"C._lock"}


def test_param_release_and_store_summaries(tmp_path):
    index, path = _index_for(tmp_path, """
        class C:
            def releaser(self, slot):
                self.srv.evict(slot)

            def storer(self, slot, req):
                self._active[slot] = req

            def forwarder(self, slot):
                self.releaser(slot)
        """)
    assert "slot" in index.func(f"{path}::C.releaser").param_release
    st = index.func(f"{path}::C.storer")
    assert {"slot", "req"} <= st.param_store
    assert "slot" in index.func(f"{path}::C.forwarder").param_release


def test_facts_cache_invalidates_on_mtime_change(tmp_path):
    """The per-file cache is keyed on (mtime, size): editing the file
    must re-extract, an untouched file must hit the cache (object
    identity) — this is what keeps the whole-tree gate fast."""
    src = tmp_path / "cached.py"
    src.write_text("def f():\n    pass\n")
    first = callgraph.module_facts(str(src), None)
    again = callgraph.module_facts(str(src), None)
    assert first is again                      # cache hit
    os.utime(str(src), (1, 1))                 # force a distinct mtime
    src.write_text("def f():\n    raise ValueError()\n")
    changed = callgraph.module_facts(str(src), None)
    assert changed is not first
    assert changed.functions["f"].direct_raise
