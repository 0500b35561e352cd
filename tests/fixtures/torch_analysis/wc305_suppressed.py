"""WC305 fixture — suppressed occurrence (a deliberate zero: test
double pinning legacy serialization)."""


def stats():
    return {
        "free_blocks": 0,  # tpushare: ignore[WC305]
        "completed": 3,
    }
