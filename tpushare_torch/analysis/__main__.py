"""CLI: ``python -m tpushare_torch.analysis [paths...] [--check] [--diff REF]``.

Modes:
- default: list every finding (baselined ones tagged), exit 0 —
  the exploratory/report view.
- ``--check``: the ratchet gate. Exit **1** on any finding NOT in the
  baseline or any baseline entry without a note; exit **2** when the only problem is stale baseline
  entries (fixed violations whose entries must be pruned — the
  distinct code tells "you broke something" apart from "you fixed
  something, now prune"). Identical to what tests/test_torch_analysis.py
  enforces in tier-1, so the test and the local gate cannot drift
  apart.
- ``--diff REF``: analyze only the files changed vs the merge-base
  with REF (plus uncommitted/untracked work). The inter-procedural
  call graph is STILL built project-wide, so transitive rules (TS104,
  RL4xx, CC204) stay sound — only the reporting narrows:
  ``python -m tpushare_torch.analysis --check --diff origin/main``.
- ``--update-baseline``: rewrite the baseline to the current findings,
  keeping justification notes of surviving entries and PRINTING every
  entry it pruned (a silently shrinking ratchet is unauditable).
- ``--format {text,json,sarif}``: sarif is the GitHub code-scanning
  upload format; ``--json`` is an alias for ``--format json``.
- ``--overlap-report SET_A SET_B [--overlap-baseline FILE]``: the
  read/write footprint intersection of two entry sets (the overlapped
  tick's ``tick-dispatch`` and ``tick-schedule``); with the baseline,
  exit 1 when a conflict field is missing from it
  (``tpushare_torch/analysis/overlap_baseline.json``).
- ``--wire-table``: the generated ``/stats`` schema tables of
  ``docs/torch/SERVING_WIRE.md``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from typing import List, Optional

from tpushare_torch.analysis import baseline as baseline_mod
from tpushare_torch.analysis import reporters
from tpushare_torch.analysis.config import load_config
from tpushare_torch.analysis.engine import all_rules, analyze_paths, relativize

EXIT_OK = 0
EXIT_NEW_FINDINGS = 1
EXIT_STALE_BASELINE = 2


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m tpushare_torch.analysis",
        description="the PyTorch port's static analysis "
                    "(host syncs / generator discipline / concurrency / "
                    "ownership / wire-contract / inter-procedural "
                    "resource & lock rules)")
    p.add_argument("paths", nargs="*",
                   help="files or directories (default: the port's "
                        "paths, tpushare_torch/analysis/config.py)")
    p.add_argument("--check", action="store_true",
                   help="ratchet gate: exit 1 on findings not in the "
                        "baseline, exit 2 on stale baseline entries")
    p.add_argument("--diff", metavar="REF", default=None,
                   help="analyze only files changed vs the merge-base "
                        "with REF (call graph stays project-wide), "
                        "e.g. --check --diff origin/main")
    p.add_argument("--format", choices=["text", "json", "sarif"],
                   default=None, help="output format (default text)")
    p.add_argument("--json", action="store_true",
                   help="alias for --format json")
    p.add_argument("--output", default=None, metavar="FILE",
                   help="write the report to FILE instead of stdout "
                        "(exit codes unchanged)")
    p.add_argument("--baseline", default=None,
                   help="baseline file (default: the config's)")
    p.add_argument("--no-baseline", action="store_true",
                   help="ignore the baseline entirely")
    p.add_argument("--update-baseline", action="store_true",
                   help="rewrite the baseline to the current findings "
                        "(prints every pruned entry)")
    p.add_argument("--list-rules", action="store_true",
                   help="list registered rules and exit")
    p.add_argument("--explain", metavar="RULE", default=None,
                   help="print one rule's doc, a live positive/"
                        "negative example from its fixtures, and its "
                        "suppression spelling, then exit")
    p.add_argument("--rule-table", action="store_true",
                   help="print the generated markdown rule table "
                        "(the text between the port's RULE TABLE "
                        "markers in README.md)")
    p.add_argument("--wire-table", action="store_true",
                   help="print the generated /stats wire-schema tables "
                        "(the text between the WIRE TABLE markers in "
                        "docs/torch/SERVING_WIRE.md)")
    p.add_argument("--overlap-report", nargs=2, metavar=("SET_A", "SET_B"),
                   default=None,
                   help="emit the read/write footprint intersection of "
                        "two entry sets instead of rule findings. Each "
                        "set is a named surface (tick-dispatch, "
                        "tick-schedule) or comma-separated "
                        "Class.method specs; honors --format/--output. "
                        "This is the overlapped tick's gate artifact")
    p.add_argument("--overlap-baseline", metavar="FILE", default=None,
                   help="with --overlap-report: exit 1 if any conflict "
                        "field is absent from FILE (the committed, "
                        "justified overlap artifact)")
    p.add_argument("--jobs", type=int, default=None, metavar="N",
                   help="fan per-file parse/summary extraction over N "
                        "processes (default: os.cpu_count(); results "
                        "are byte-identical to --jobs 1)")
    p.add_argument("--root", default=None,
                   help="repo root (default: nearest pyproject.toml)")
    return p


def _git(root: str, *args: str) -> str:
    proc = subprocess.run(["git", *args], cwd=root, capture_output=True,
                          text=True, timeout=60)
    if proc.returncode != 0:
        raise RuntimeError(f"git {' '.join(args)} failed: "
                           f"{proc.stderr.strip() or proc.stdout.strip()}")
    return proc.stdout


def changed_files(root: str, ref: str) -> List[str]:
    """Absolute paths of .py files changed vs merge-base(ref, HEAD):
    committed + staged + unstaged + untracked. Deleted files drop out
    (nothing to analyze); the stale-entry check against them belongs
    to the full run.

    ``git diff --name-only`` prints paths relative to the repository
    TOPLEVEL, not the cwd — when the analysis root is a subdirectory
    (monorepo layout), joining onto ``root`` would produce nonexistent
    paths and silently empty the diff set. Everything is therefore
    anchored at the toplevel (``ls-files --full-name`` matches)."""
    try:
        top = _git(root, "rev-parse", "--show-toplevel").strip() or root
    except RuntimeError:
        top = root
    try:
        base = _git(root, "merge-base", ref, "HEAD").strip()
    except RuntimeError:
        # No merge-base (shallow clone, unborn ref): fall back to the
        # ref itself so --diff still narrows instead of dying.
        base = ref
    names = set()
    out = _git(root, "diff", "--name-only", base, "--", "*.py")
    names.update(l.strip() for l in out.splitlines() if l.strip())
    out = _git(root, "ls-files", "--others", "--exclude-standard",
               "--full-name", "--", "*.py")
    names.update(l.strip() for l in out.splitlines() if l.strip())
    paths = []
    for name in sorted(names):
        full = os.path.join(top, name)
        if os.path.isfile(full):
            paths.append(full)
    return paths


def _overlap_mode(args, config, default_paths: List[str], fmt: str,
                  jobs: int) -> int:
    """--overlap-report SET_A SET_B [--overlap-baseline FILE]."""
    import json

    from tpushare_torch.analysis import callgraph, threads
    from tpushare_torch.analysis.engine import iter_py_files

    names: List[str] = []
    entry_sets: List[List[str]] = []
    for i, spec in enumerate(args.overlap_report):
        if spec in threads.DEFAULT_SURFACES:
            names.append(spec)
            entry_sets.append(list(threads.DEFAULT_SURFACES[spec]))
        else:
            names.append(f"set{i + 1}")
            entry_sets.append([s for s in spec.split(",") if s])
    files = sorted(iter_py_files(default_paths, exclude=config.exclude))
    index = callgraph.build_index(files, root=config.root, jobs=jobs)
    report = threads.overlap_report(index, config, entry_sets[0],
                                    entry_sets[1],
                                    names=(names[0], names[1]))
    for side in names:
        for spec in report[side]["unresolved"]:
            print(f"warning: [{side}] entry {spec!r} resolved no "
                  f"function", file=sys.stderr)
    if fmt == "sarif":
        out = json.dumps(threads.render_overlap_sarif(
            report, names=(names[0], names[1])), indent=2)
    elif fmt == "json":
        out = json.dumps(report, indent=2, sort_keys=True)
    else:
        out = threads.render_overlap_text(report,
                                          names=(names[0], names[1]))
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    else:
        print(out)
    if args.overlap_baseline:
        try:
            with open(args.overlap_baseline, encoding="utf-8") as f:
                committed = json.load(f)
        except (OSError, ValueError) as e:
            print(f"--overlap-baseline {args.overlap_baseline}: {e}",
                  file=sys.stderr)
            return EXIT_NEW_FINDINGS
        known = {c.get("field") for c in committed.get("conflicts", [])}
        fresh = [c for c in report["conflicts"]
                 if c["field"] not in known]
        gone = sorted(known - {c["field"]
                               for c in report["conflicts"]})
        for field in gone:
            print(f"note: baselined overlap on {field!r} no longer "
                  f"detected (prune it from {args.overlap_baseline})",
                  file=sys.stderr)
        if fresh:
            print(f"FAIL: {len(fresh)} overlap conflict(s) not in "
                  f"{args.overlap_baseline}; every shared field needs "
                  f"a written serialization justification there:",
                  file=sys.stderr)
            for c in fresh:
                print(f"  new overlap: {c['field']}", file=sys.stderr)
            return EXIT_NEW_FINDINGS
        print(f"OK: all {len(report['conflicts'])} overlap "
              f"conflict(s) justified in {args.overlap_baseline}",
              file=sys.stderr)
    return EXIT_OK


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)
    config = load_config(root=args.root)
    fmt = args.format or ("json" if args.json else "text")

    if args.list_rules:
        for rule in all_rules():
            scope = ", ".join(rule.paths) or "whole tree"
            print(f"{rule.id}  {rule.name}  [{scope}]\n    {rule.description}")
        return EXIT_OK

    if args.rule_table:
        from tpushare_torch.analysis import ruledoc
        print(ruledoc.table_block())
        return EXIT_OK

    if args.wire_table:
        from tpushare_torch.analysis import callgraph, wire
        from tpushare_torch.analysis.engine import iter_py_files
        files = sorted(iter_py_files(
            [config.resolve(p) for p in config.paths],
            exclude=config.exclude))
        index = callgraph.build_index(files, root=config.root,
                                      jobs=args.jobs or 0)
        print(wire.table_block(wire.build(index, config)), end="")
        return EXIT_OK

    if args.explain is not None:
        from tpushare_torch.analysis import ruledoc
        wanted = args.explain.upper()
        for rule in all_rules():
            if rule.id == wanted:
                try:
                    print(ruledoc.explain(rule, config))
                except ruledoc.ExplainError as e:
                    print(f"explain failed: {e}", file=sys.stderr)
                    return EXIT_NEW_FINDINGS
                return EXIT_OK
        known = ", ".join(sorted(r.id for r in all_rules()))
        print(f"unknown rule {args.explain!r}; registered: {known}",
              file=sys.stderr)
        return EXIT_NEW_FINDINGS

    # --jobs: per-file parse/summary fan-out (byte-identical results);
    # default one worker per core, the serial path when that is 1.
    jobs = args.jobs if args.jobs is not None else (os.cpu_count() or 1)

    default_paths = [config.resolve(p) for p in config.paths]

    if args.overlap_report is not None:
        return _overlap_mode(args, config, default_paths, fmt, jobs)
    if args.diff is not None:
        if args.paths:
            print("--diff and explicit paths are mutually exclusive",
                  file=sys.stderr)
            return EXIT_NEW_FINDINGS
        try:
            diff_paths = changed_files(config.root, args.diff)
        except RuntimeError as e:
            print(f"--diff {args.diff}: {e}", file=sys.stderr)
            return EXIT_NEW_FINDINGS
        # Only changed files under the configured analysis roots: a
        # changed test or demo file outside them is not gated here.
        roots = [os.path.abspath(p) for p in default_paths]
        diff_paths = [p for p in diff_paths
                      if any(os.path.abspath(p) == r
                             or os.path.abspath(p).startswith(r + os.sep)
                             for r in roots)]
        if not diff_paths:
            print("OK: no analyzed files changed vs "
                  f"{args.diff} (call graph not consulted)")
            return EXIT_OK
        # Narrow reporting, project-wide resolution: the index covers
        # the full configured tree so chains INTO unchanged files hold.
        findings = analyze_paths(diff_paths, config,
                                 project_paths=default_paths,
                                 jobs=jobs)
        analyzed_rel = {relativize(p, config.root) for p in diff_paths}
    else:
        paths = args.paths or default_paths
        findings = analyze_paths(paths, config, jobs=jobs)
        analyzed_rel = None

    baseline_path = args.baseline or config.resolve(config.baseline)
    entries = [] if args.no_baseline else baseline_mod.load(baseline_path)
    if analyzed_rel is not None:
        # A diff run sees findings only for changed files; comparing
        # the whole baseline against them would mark every untouched
        # file's entries stale. Scope the ratchet the same way.
        entries = [e for e in entries if e.get("path") in analyzed_rel]
    new, stale = baseline_mod.diff(findings, entries)

    if args.update_baseline:
        if args.diff is not None:
            print("--update-baseline requires a full run (a diff-"
                  "scoped rewrite would drop every other entry)",
                  file=sys.stderr)
            return EXIT_NEW_FINDINGS
        baseline_mod.save(baseline_path, findings, old_entries=entries)
        for e in stale:
            print(f"pruned stale entry: {e.get('rule')} "
                  f"{e.get('path')} {e.get('snippet', '')[:70]!r}"
                  + (f"  (note: {e['note']})" if e.get("note") else ""))
        print(f"baseline updated: {baseline_path} "
              f"({len(findings)} entries, {len(stale)} pruned)")
        return EXIT_OK

    render = {"json": reporters.render_json,
              "sarif": reporters.render_sarif,
              "text": reporters.render_text}[fmt]
    shown = new if (args.check and fmt == "text") else findings
    kwargs = {"new": None if (args.check and fmt == "text") else new,
              "stale": stale}
    if fmt == "sarif":
        kwargs["rules"] = all_rules()
    out = render(shown, **kwargs)
    if args.output:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(out + "\n")
    elif out:
        print(out)
    if args.check:
        # The gate fails on BOTH directions of baseline drift, exactly
        # like tests/test_torch_analysis.py — but with DISTINCT exit
        # codes: 1 = new findings (you broke the ratchet), 2 = stale
        # entries only (you fixed a violation; prune its entry).
        if new:
            print(f"FAIL: {len(new)} new finding(s) not in the baseline "
                  f"({baseline_path}); fix them, add a `# tpushare: "
                  f"ignore[RULE]` with cause, or record them with "
                  f"--update-baseline plus a justification note",
                  file=sys.stderr)
            return EXIT_NEW_FINDINGS
        bare = baseline_mod.unjustified(entries)
        if bare:
            print(f"FAIL: {len(bare)} baseline entr(y/ies) without a "
                  f"justification note ({baseline_path}); every "
                  f"recorded exception carries its cause:",
                  file=sys.stderr)
            for e in bare:
                print(f"  no note: {e.get('rule')} {e.get('path')} "
                      f"{e.get('snippet', '')!r}", file=sys.stderr)
            return EXIT_NEW_FINDINGS
        if stale:
            # List the EXACT stale entries (rule, path, snippet) so a
            # CI log is actionable without reproducing the run
            # locally — "2 stale entries" alone names nothing.
            print(f"FAIL: {len(stale)} stale baseline entr(y/ies) whose "
                  f"violations are fixed; run "
                  f"`python -m tpushare_torch.analysis --update-baseline` to "
                  f"prune them ({baseline_path}):", file=sys.stderr)
            for e in stale:
                note = f"  (note: {e['note']})" if e.get("note") else ""
                print(f"  stale: {e.get('rule')} {e.get('path')} "
                      f"{e.get('snippet', '')!r}{note}", file=sys.stderr)
            return EXIT_STALE_BASELINE
        print(f"OK: no new findings ({len(findings)} baselined)")
    return EXIT_OK


if __name__ == "__main__":
    sys.exit(main())
