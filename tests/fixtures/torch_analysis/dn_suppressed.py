"""DN601 fixture — suppressed on its line with a cause."""


def peek(t):
    h = t.to("cpu", non_blocking=True)
    return h.tolist()  # tpushare: ignore[DN601] CPU tensors only: the copy is synchronous
