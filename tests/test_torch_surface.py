"""What the port still lacks of the JAX package's public surface, held to
the recorded list.

For each module ``tpushare/X.py`` the public top-level names (functions,
classes, assigned constants) its counterpart ``tpushare_torch/X.py``
neither defines nor imports are the diff below, and a missing module is
listed whole. Every entry is TPU-only or JAX-only, and ROADMAP.md §C
names each one with its reason: a new gap fails here until it is
ported or recorded there, and a name the port gains must leave the
list.
"""

import ast
import os

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: module -> names the port does not carry; None: no counterpart module.
RECORDED = {
    "ops/flash_attention.py": {
        "DECODE_KERNEL_ENV", "DEFAULT_BLOCK_K", "DEFAULT_BLOCK_Q",
        "MAX_RESIDENT_KV_BYTES", "PAGED_Q8_KERNEL_MIN_CTX",
        "decode_eligible", "flash_eligible", "paged_decode_eligible",
        "paged_verify_eligible", "partial_reference"},
    "ops/q8_expert.py": {
        "DEFAULT_BLOCK_F", "Q8_EXPERT_KERNEL_ENV", "Q8_VMEM_BUDGET",
        "q8_dispatch_mode", "q8_expert_eligible"},
    "parallel/mesh.py": {"named_sharding", "tenant_mesh"},
    "parallel/sharding.py": {"tree_shardings"},
    "plugin/backend.py": {"JaxBackend", "KNOWN_TOPOLOGIES",
                          "MetadataBackend", "SysfsBackend"},
    "plugin/libtpudisc.py": None,
    "plugin/nativedisc.py": None,
    "plugin/topology.py": {"log", "tpu_env_for_chips"},
    "models/quant.py": {"kv_scale_pad"},
    "analysis/callgraph.py": {"KEY_NONCONSUMING", "SYNC_ATTR_READS",
                              "is_key_consuming_call"},
    "analysis/config.py": {"SECTION"},
    "analysis/dataflow.py": {"JIT_LEAVES", "JitInfo", "class_jit_handles",
                             "module_jit_handles", "parse_jit_call"},
    "analysis/hooksync.py": None,
    "analysis/rules/donation.py": {"DonateAliasedBuffer", "ReadAfterDonate"},
    "analysis/rules/keylineage.py": {"KeyConsumedTwice",
                                     "SplitParentReused"},
    "analysis/rules/recompile.py": {"RecompileChurn"},
    "analysis/rules/tracer_escape.py": {"TracerEscape"},
    "analysis/rules/tracer_safety.py": {"HostSyncInJit", "JIT_WRAPPERS",
                                        "PrngKeyReuse"},
}


def _names(path, with_imports):
    tree = ast.parse(open(path, encoding="utf-8").read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            out.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and with_imports:
            out.update(a.asname or a.name for a in node.names)
    return {n for n in out if not n.startswith("_")}


def _surface_diff():
    diff = {}
    root = os.path.join(REPO, "tpushare")
    for dirpath, _, files in os.walk(root):
        for name in files:
            if not name.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(dirpath, name), root)
            port = os.path.join(REPO, "tpushare_torch", rel)
            if not os.path.exists(port):
                diff[rel.replace(os.sep, "/")] = None
                continue
            missing = (_names(os.path.join(dirpath, name), False)
                       - _names(port, True))
            if missing:
                diff[rel.replace(os.sep, "/")] = missing
    return diff


def test_public_surface_diff_is_the_recorded_one():
    assert _surface_diff() == RECORDED


def test_roadmap_gives_each_gap_its_reason():
    text = open(os.path.join(REPO, "ROADMAP.md"), encoding="utf-8").read()
    section = text[text.index("### C. Port faults against the reference"):
                   text.index("## Recent")]
    for rel, names in RECORDED.items():
        if names is None:
            assert f"`{os.path.basename(rel)}`" in section, rel
            continue
        for name in names:
            assert f"`{name}`" in section, (rel, name)


def test_measurement_layer_is_no_longer_a_gap():
    """The names this slice ported stay ported."""
    diff = _surface_diff()
    for rel in ("utils/profiling.py", "models/moe.py", "models/paged.py",
                "analysis/threads.py", "analysis/wire.py"):
        assert rel not in diff, (rel, diff.get(rel))
    assert "param_bytes" not in diff["models/quant.py"]
