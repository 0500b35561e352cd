"""WC305 fixture — negatives: None for absence, computed values, and
zeros on keys outside the contract."""


def stats(pool, dev):
    out = {
        "free_blocks": pool.free if pool else None,
        "pool_free_frac": pool.frac if pool else None,
        "completed": 0,                    # not a contract key
        "queue_depth": len([]),            # computed, not constant
    }
    out["degraded"] = dev.degraded if dev else None
    out["live_blocks"] = pool.live if pool else None
    return out
