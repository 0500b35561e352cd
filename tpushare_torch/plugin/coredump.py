"""Crash diagnostics, all-thread stack capture: the port's copy of
``tpushare/plugin/coredump.py`` (the reference plugin dumps its
goroutines on SIGQUIT, coredump.go; here Python threads).
"""

from __future__ import annotations

import sys
import threading
import traceback


def stack_trace() -> str:
    """Render every live thread's stack (reference: StackTrace,
    coredump.go:10-25)."""
    frames = sys._current_frames()
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in frames.items():
        out.append(f"--- thread {names.get(ident, '?')} ({ident}) ---")
        out.extend(line.rstrip() for line in traceback.format_stack(frame))
    return "\n".join(out) + "\n"


def coredump(file_name: str) -> None:
    """Write the dump (reference: coredump, coredump.go:27-30)."""
    with open(file_name, "w") as f:
        f.write(stack_trace())
