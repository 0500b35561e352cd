"""TO901 suppressed fixture — the static pass is shown the ignore.

Unlike the other analysis fixtures this one is RUNNABLE on purpose:
tests/test_ownership.py imports it, arms the runtime sanitizer
(TPUSHARE_OWNERSHIP_CHECKS=1), and proves that the very write the
``# tpushare: ignore[TO901]`` hides from the static rule still raises
OwnershipViolation live — the dynamic counterpart keeps suppressions
honest. No thread is started at import (the analyzer only needs the
Thread(target=...) SITE to infer roles; the runtime test drives the
methods itself)."""
import threading


class SuppressedLedger:
    def __init__(self):
        self._tier_breaches = {"interactive": 0}  # tpushare: owner[engine]
        self._loop_thread = threading.Thread(target=self._loop,
                                             daemon=True)

    def _loop(self):
        self._tier_breaches["interactive"] += 1

    def do_POST(self):
        # "reviewed, believed benign" — exactly the claim the runtime
        # sanitizer exists to test in storm runs
        self._tier_breaches["interactive"] = 0  # tpushare: ignore[TO901]
