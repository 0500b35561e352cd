"""RL403: non-atomic persistent writes in durable/persistence modules.

A file that another process (or the NEXT life of this process) re-reads
must never be observable half-written: ``open(path, "w")`` truncates
the destination in place, so a crash between the truncate and the
final flush leaves a torn file that poisons the next reader — the
journal checkpoint meta, the analysis baseline ratchet, and the
ParamStore checkpoint metadata are all exactly this shape. The safe
pattern has ONE home (``tpushare_torch/utils/atomicio.py``: write-tmp ->
fsync -> rename), and this rule pins the persistence modules to it.

Append-mode opens (``"a"``/``"ab"``) are deliberately exempt: the
durable journal's segments are append-only WITH record framing
(length-prefix + CRC), so a torn tail is discarded on replay — that IS
the crash-consistency design, not a violation of it. Reads are exempt
for the obvious reason.

Scoped to the modules whose writes cross process boundaries (the
``paths`` list below); the scope is the "later re-read across process
boundaries" approximation — a module lives here exactly because its
files are another process's inputs.
"""

from __future__ import annotations

import ast
from typing import Iterator

from tpushare_torch.analysis.engine import FileContext, Finding, Rule, register
from tpushare_torch.analysis.rules._util import dotted

#: open() modes that truncate/create in place (exclusive-create "x"
#: counts too: a crash mid-write still strands a torn file under the
#: final name)
_UNSAFE_PREFIXES = ("w", "x")


def _mode_of(call: ast.Call):
    """The mode argument of an ``open()`` call, if statically known."""
    mode = None
    if len(call.args) >= 2:
        mode = call.args[1]
    for kw in call.keywords:
        if kw.arg == "mode":
            mode = kw.value
    if mode is None:
        return "r"                      # open() default
    if isinstance(mode, ast.Constant) and isinstance(mode.value, str):
        return mode.value
    return None                         # dynamic: can't judge


@register
class NonAtomicPersistentWrite(Rule):
    id = "RL403"
    name = "non-atomic-persistent-write"
    family = "resource-leak"
    description = ("open(..., 'w') in a durable/persistence module: a "
                   "crash mid-write strands a torn file the next "
                   "process reads — use utils/atomicio (write-tmp -> "
                   "fsync -> rename); append-mode journal segments "
                   "(CRC-framed, torn tail discarded on replay) are "
                   "exempt")
    paths = (
        "tpushare_torch/durable/",
        "tpushare_torch/analysis/baseline.py",
        "tpushare_torch/models/reshard.py",
        "tpushare_torch/utils/checkpoint.py",
    )

    def check(self, ctx: FileContext) -> Iterator[Finding]:
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name not in ("open", "io.open", "os.fdopen"):
                continue
            mode = _mode_of(node)
            if mode is None or not mode.startswith(_UNSAFE_PREFIXES):
                continue
            yield ctx.finding(
                "RL403", node,
                f"open(..., {mode!r}) writes a persistent file in "
                f"place — a crash mid-write strands a torn file for "
                f"the next process; use utils/atomicio.write_bytes/"
                f"write_json (write-tmp -> fsync -> rename) instead")
