"""WC305 fixture — true positives. Parsed by the analyzer, never run.

``free_blocks``/``pool_free_frac``/``degraded`` are null-not-zero
contract keys: when the backing subsystem is absent they must
serialize as None, never a constant zero/False.
"""


def stats(pool):
    out = {
        "free_blocks": 0,                        # WC305: must be None
        "pool_free_frac": pool.frac if pool else 0.0,   # WC305 arm
        "completed": 0,                          # uncontracted: fine
    }
    out["degraded"] = False                      # WC305: must be None
    return out
