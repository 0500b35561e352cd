"""The port's flow-sensitive dataflow engine and the PyTorch-specific
rule families: PK (generator discipline), DN601 (a host read before its
non_blocking copy is done), TE701 (tensors escaping autograd scope) and
JC801 (a kernel built per call) — the counterpart of
test_dataflow_analysis.py.

Fast tier: the analyzer imports nothing but the standard library.
Fixture tests prove each family's positive/negative/suppressed
behavior; every family has a seeded RED test whose finding comes from
THAT rule and is not absorbed by the checked-in baseline; the walker
tests pin the control-flow shapes (branch joins, early returns, loops,
try/finally, aliases) on the async-copy domain.
"""

import ast
import os
import textwrap

from tpushare_torch.analysis import baseline as baseline_mod
from tpushare_torch.analysis import callgraph, dataflow
from tpushare_torch.analysis import load_config
from tpushare_torch.analysis.engine import all_rules, analyze_file, analyze_paths

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "fixtures", "torch_analysis")
CONFIG = load_config(root=REPO)


def rules_of(prefix):
    picked = [r for r in all_rules() if r.id.startswith(prefix)]
    assert picked, f"no rules registered under {prefix}"
    return picked


def rules_except(rule_id):
    return [r for r in all_rules() if r.id != rule_id]


def run_fixture(name, prefix):
    return analyze_file(os.path.join(FIXTURES, name), CONFIG,
                        rules=rules_of(prefix), respect_scope=False)


def run_source(tmp_path, source, rules, name="seeded.py"):
    src = tmp_path / name
    src.write_text(textwrap.dedent(source))
    return analyze_file(str(src), CONFIG, rules=rules,
                        respect_scope=False)


def not_absorbed(found):
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(found, entries)
    return len(new) == len(found)


# ---------------------------------------------------------------------------
# PK501 / PK502 — generator discipline
# ---------------------------------------------------------------------------

def test_pk_positives():
    found = run_fixture("pk_positive.py", "PK")
    pk501 = [f for f in found if f.rule == "PK501"]
    pk502 = [f for f in found if f.rule == "PK502"]
    assert len(pk501) == 5, found
    msgs = " ".join(f.message for f in pk501)
    for token in ("torch.rand()", "torch.multinomial()",
                  "torch.nn.init.normal_()", ".uniform_()", "torch.randn()"):
        assert token in msgs, token
    assert len(pk502) == 2, found
    assert {f.message.split("()")[0] for f in pk502} == {
        "torch.manual_seed", "torch.cuda.manual_seed_all"}


def test_pk_negatives():
    assert run_fixture("pk_negative.py", "PK") == []


def test_pk_suppressed():
    assert run_fixture("pk_suppressed.py", "PK") == []


def test_pk501_red_seeded_draw_not_absorbed(tmp_path):
    source = """
        import torch

        def dropout_mask(x, p):
            return torch.bernoulli(torch.full_like(x, 1 - p))
        """
    found = run_source(tmp_path, source, rules_of("PK501"))
    assert [f.rule for f in found] == ["PK501"]
    assert run_source(tmp_path, source, rules_except("PK501"),
                      name="off.py") == []
    assert not_absorbed(found)


def test_pk502_scope_exempts_entry_points():
    """Seeding belongs to the entry points: tools/ and the smoke
    scripts may seed the global stream, library modules may not."""
    rule = next(r for r in all_rules() if r.id == "PK502")
    assert rule.applies_to("tpushare_torch/models/serving.py")
    assert rule.applies_to("tpushare_torch/cli/serve.py")
    assert not rule.applies_to("tpushare_torch/tools/multichip.py")
    assert not rule.applies_to("tpushare_torch/chaos/smoke.py")
    assert not rule.applies_to("chip_smoke.py")


def test_pk502_red_seeded_reseed_not_absorbed(tmp_path):
    source = """
        import torch

        def reset(seed):
            torch.cuda.manual_seed(seed)
        """
    found = run_source(tmp_path, source, rules_of("PK502"))
    assert [f.rule for f in found] == ["PK502"]
    assert not_absorbed(found)


def test_samplers_draw_from_their_own_generator():
    """The real serving samplers and the speculative accept draws pass
    their server's torch.Generator on every draw."""
    for rel in ("models/serving.py", "models/spec.py", "models/generate.py",
                "models/transformer.py", "models/moe.py"):
        found = analyze_file(os.path.join(REPO, "tpushare_torch", rel),
                             CONFIG, rules=rules_of("PK"))
        assert found == [], [f.render() for f in found]


# ---------------------------------------------------------------------------
# DN601 — host read before the non_blocking copy is done
# ---------------------------------------------------------------------------

def test_dn_positives():
    found = run_fixture("dn_positive.py", "DN")
    assert len(found) == 4, found
    msgs = " ".join(f.message for f in found)
    for token in (".tolist()", ".item()", "np.asarray()", ".numpy()"):
        assert token in msgs, token
    assert all("in flight" in f.message for f in found)


def test_dn_negatives():
    assert run_fixture("dn_negative.py", "DN") == []


def test_dn_suppressed():
    assert run_fixture("dn_suppressed.py", "DN") == []


def test_dn601_red_seeded_read_not_absorbed(tmp_path):
    source = """
        import torch

        def snapshot(dev):
            buf = torch.empty(dev.shape, dtype=dev.dtype, pin_memory=True)
            buf.copy_(dev, non_blocking=True)
            return bytes(buf.numpy())
        """
    found = run_source(tmp_path, source, rules_of("DN601"))
    assert [f.rule for f in found] == ["DN601"]
    assert run_source(tmp_path, source, rules_except("DN601"),
                      name="off.py") == []
    assert not_absorbed(found)


def test_dn601_follows_aliases_and_self_places(tmp_path):
    found = run_source(tmp_path, """
        class Stager:
            def fetch(self, t):
                self._host = t.to("cpu", non_blocking=True)
                view = self._host
                return view.tolist()
        """, rules_of("DN601"))
    assert len(found) == 1, found


def test_dn601_synchronize_on_either_branch_is_not_enough(tmp_path):
    """In flight on one path is in flight after the join."""
    found = run_source(tmp_path, """
        def fetch(t, ev, fast):
            h = t.to("cpu", non_blocking=True)
            if fast:
                ev.synchronize()
            else:
                pass
            return h.tolist()
        """, rules_of("DN601"))
    assert len(found) == 1, found
    clean = run_source(tmp_path, """
        def fetch(t, ev, fast):
            h = t.to("cpu", non_blocking=True)
            if fast:
                ev.synchronize()
            else:
                ev.synchronize()
            return h.tolist()
        """, rules_of("DN601"), name="both.py")
    assert clean == [], clean


def test_dn601_early_return_does_not_poison_fallthrough(tmp_path):
    found = run_source(tmp_path, """
        def fetch(t, ev, skip):
            h = t.to("cpu", non_blocking=True)
            if skip:
                return h
            ev.synchronize()
            return h.tolist()
        """, rules_of("DN601"))
    assert found == [], found


def test_dn601_loop_carried_copy_flags_on_the_second_pass(tmp_path):
    """A read at the top of the loop sees the copy issued at the
    bottom of the previous iteration."""
    found = run_source(tmp_path, """
        import torch

        def drain(chunks):
            buf = torch.empty(16, pin_memory=True)
            out = []
            for c in chunks:
                out.append(buf.tolist())
                buf.copy_(c, non_blocking=True)
            return out
        """, rules_of("DN601"))
    assert len(found) == 1, found


def test_dn601_finally_runs_after_a_return(tmp_path):
    found = run_source(tmp_path, """
        def fetch(t, ev):
            h = t.to("cpu", non_blocking=True)
            try:
                return 0
            finally:
                h.tolist()
        """, rules_of("DN601"))
    assert len(found) == 1, found


def test_dn601_rebinding_severs_the_old_buffer(tmp_path):
    found = run_source(tmp_path, """
        def fetch(t):
            h = t.to("cpu", non_blocking=True)
            h = t.to("cpu")
            return h.tolist()
        """, rules_of("DN601"))
    assert found == [], found


def test_dn601_real_tree_copies_are_waited_on():
    """The port's device->host copies into page-locked memory (the
    engine's /kv/blocks read, the tier's demotions, the checkpoint's
    staged writes) wait before they read: DN601 is clean on the tree."""
    found = analyze_paths([os.path.join(REPO, "tpushare_torch")], CONFIG,
                          rules=rules_of("DN601"))
    assert found == [], [f.render() for f in found]


# ---------------------------------------------------------------------------
# TE701 — tensors escaping autograd scope
# ---------------------------------------------------------------------------

def test_te_positives():
    found = run_fixture("te_positive.py", "TE")
    assert len(found) == 4, found
    msgs = " ".join(f.message for f in found)
    assert "forward output 'out' held as ctx.out" in msgs
    assert "the global '_last'" in msgs
    assert "the captured mutable 'ACTIVATIONS'" in msgs
    assert "'self.last_hidden' on self" in msgs


def test_te_negatives():
    assert run_fixture("te_negative.py", "TE") == []


def test_te_suppressed():
    assert run_fixture("te_suppressed.py", "TE") == []


def test_te701_red_seeded_escape_not_absorbed(tmp_path):
    source = """
        import torch

        class Cached(torch.autograd.Function):
            @staticmethod
            def backward(ctx, g):
                Cached.last_grad = g
                return g
        """
    found = run_source(tmp_path, source, rules_of("TE701"))
    assert [f.rule for f in found] == ["TE701"]
    assert run_source(tmp_path, source, rules_except("TE701"),
                      name="off.py") == []
    assert not_absorbed(found)


def test_te701_tuple_unpack_to_self(tmp_path):
    found = run_source(tmp_path, """
        from torch.utils.checkpoint import checkpoint

        class M:
            def run(self, x, f):
                def block(h):
                    self.a, self.b = f(h)
                    return h
                return checkpoint(block, x, use_reentrant=False)
        """, rules_of("TE701"))
    assert len(found) == 2, found


def test_te701_vararg_kwarg_params_are_locals(tmp_path):
    found = run_source(tmp_path, """
        import torch

        class F(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *xs, **kw):
                xs[0].add_(1)
                kw["y"] = xs[0]
                return xs[0]
        """, rules_of("TE701"))
    assert found == [], found


def test_te701_real_functions_save_for_backward():
    found = analyze_paths([os.path.join(REPO, "tpushare_torch", d)
                           for d in ("models", "ops", "parallel")],
                          CONFIG, rules=rules_of("TE701"))
    assert found == [], [f.render() for f in found]


# ---------------------------------------------------------------------------
# JC801 — kernel built per call
# ---------------------------------------------------------------------------

def test_jc_positives():
    found = run_fixture("jc_positive.py", "JC")
    assert len(found) == 3, found
    msgs = " ".join(f.message for f in found)
    assert "ctypes.CDLL() in launch_decode()" in msgs
    assert "cpp_extension.load_inline() in fused_norm()" in msgs
    assert "@triton.jit kernel '_add' defined inside triton_add()" in msgs


def test_jc_negatives():
    assert run_fixture("jc_negative.py", "JC") == []


def test_jc_suppressed():
    assert run_fixture("jc_suppressed.py", "JC") == []


def test_jc801_red_seeded_build_not_absorbed(tmp_path):
    source = """
        from torch.utils.cpp_extension import load

        def wrapper(x):
            return load(name="k", sources=["k.cu"]).run(x)
        """
    found = run_source(tmp_path, source, rules_of("JC801"))
    assert found == []      # a bare `load` is not known to be cpp_extension's
    source = """
        from torch.utils import cpp_extension

        def wrapper(x):
            return cpp_extension.load(name="k", sources=["k.cu"]).run(x)
        """
    found = run_source(tmp_path, source, rules_of("JC801"), name="b.py")
    assert [f.rule for f in found] == ["JC801"]
    assert not_absorbed(found)


def test_jc801_build_module_loads_each_kernel_once():
    """ops/_build.load keeps every library in its module-level table:
    the one CDLL in the kernel tree is memoized, so JC801 is clean."""
    src = open(os.path.join(REPO, "tpushare_torch", "ops", "_build.py"),
               encoding="utf-8").read()
    assert "ctypes.CDLL(out)" in src and "_libs[name] = lib" in src
    found = analyze_paths([os.path.join(REPO, "tpushare_torch", d)
                           for d in ("models", "ops", "parallel")],
                          CONFIG, rules=rules_of("JC801"))
    assert found == [], [f.render() for f in found]


# ---------------------------------------------------------------------------
# Dataflow engine units
# ---------------------------------------------------------------------------

def test_env_alias_resolution_and_cell_kill():
    env = dataflow.Env()
    env.bind("a", dataflow.Value("inflight", line=1))
    env.bind("b", dataflow.Value("alias", data=("a",)))
    root, v = env.resolve("b")
    assert root == "a" and v.tag == "inflight"
    env.bind("bufs[0]", dataflow.Value("pinned", line=2))
    env.bind("bufs", dataflow.Value("pinned", line=3))   # rebind base
    assert env.get("bufs[0]") is None                    # cells dropped


def test_resolvable_declines_global_and_nonlocal():
    ok = ast.parse("def f(buf):\n    return buf\n").body[0]
    bad = ast.parse("def f():\n    global g\n    g = 1\n").body[0]
    nested = ast.parse(
        "def f():\n    x = 1\n    def g():\n        nonlocal x\n"
        "        x = 2\n    return g\n").body[0]
    assert dataflow.resolvable(ok)
    assert not dataflow.resolvable(bad)
    assert not dataflow.resolvable(nested)


def test_iter_functions_visits_nested_defs_with_their_class():
    tree = ast.parse(textwrap.dedent("""
        class S:
            def step(self):
                def _finalize(invalid):
                    return invalid
                return _finalize

        def free():
            pass
        """))
    got = [(c, f.name) for c, f in dataflow.iter_functions(tree)]
    assert got == [("S", "step"), (None, "_finalize"), (None, "free")]


def test_sync_vocabulary_matches_pytorch_spellings():
    from tpushare_torch.analysis.callgraph import sync_desc

    def desc(expr):
        return sync_desc(ast.parse(expr).body[0].value)

    assert desc("t.item()") == ".item()"
    assert desc("t.tolist()") == ".tolist()"
    assert desc("t.cpu()") == ".cpu()"
    assert desc("t.numpy()") == ".numpy()"
    assert desc("torch.cuda.synchronize()") == ".synchronize()"
    assert desc("ev.synchronize()") == ".synchronize()"
    assert desc('t.to("cpu")') == '.to("cpu")'
    assert desc('t.to(device="cpu")') == '.to("cpu")'
    assert desc('t.to(torch.device("cpu"))') == '.to("cpu")'
    assert desc("float(t.sum())") == "float() of a tensor"
    assert desc("int(torch.argmax(x))") == "int() of a tensor"
    assert desc("host_scalar(x)") == "host_scalar()"
    # not waits: non_blocking copies, uploads, host ints
    for expr in ('t.to("cpu", non_blocking=True)',
                 "t.cpu(non_blocking=True)", "t.to(dev)",
                 "torch.as_tensor(a)", "int(n)", "int(lnp[slot])",
                 "np.asarray(rows)"):
        assert desc(expr) is None, expr


# ---------------------------------------------------------------------------
# Parallel fact extraction (--jobs)
# ---------------------------------------------------------------------------

def test_jobs_results_byte_identical_to_serial():
    """--jobs N only prefills the same facts cache the serial path
    reads, so findings render identically."""
    paths = [CONFIG.resolve(p) for p in CONFIG.paths]
    callgraph.clear_cache()
    serial = [f.render() for f in analyze_paths(paths, CONFIG)]
    callgraph.clear_cache()
    parallel = [f.render() for f in analyze_paths(paths, CONFIG, jobs=2)]
    assert serial == parallel


def test_prefetch_skips_warm_cache(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("def f():\n    pass\n")
    first = callgraph.module_facts(str(src), None)
    callgraph.prefetch_facts([str(src)], jobs=4)     # warm: no-op
    assert callgraph.module_facts(str(src), None) is first


def test_real_tree_clean_under_the_pytorch_families():
    """PK/DN/TE/JC and TS101 over the port's tree: zero unbaselined
    findings. This is the alarm wire: a new draw off the global stream,
    early host read, escape or per-call build is a NEW finding."""
    findings = analyze_paths([CONFIG.resolve(p) for p in CONFIG.paths],
                             CONFIG,
                             rules=[r for r in all_rules()
                                    if r.id[:2] in ("PK", "DN", "TE", "JC")
                                    or r.id == "TS101"])
    entries = baseline_mod.load(CONFIG.resolve(CONFIG.baseline))
    new, _ = baseline_mod.diff(findings, entries)
    assert new == [], [f.render() for f in new]
