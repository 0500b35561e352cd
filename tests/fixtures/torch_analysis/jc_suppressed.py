"""JC801 fixture — suppressed on its line with a cause."""
import ctypes


def probe(path):
    return ctypes.CDLL(path)  # tpushare: ignore[JC801] one-shot diagnostic
