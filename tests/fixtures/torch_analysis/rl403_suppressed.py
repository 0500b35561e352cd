"""RL403 suppressed: a justified in-place write (e.g. a throwaway
debug dump no process re-reads) with the per-line opt-out. Expected:
zero findings."""

import json


def dump_debug(path, obj):
    with open(path, "w") as f:  # tpushare: ignore[RL403]
        json.dump(obj, f)
