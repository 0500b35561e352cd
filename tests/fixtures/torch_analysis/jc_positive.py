"""JC801 fixture — true positives. Parsed by the analyzer, never
imported: kernel libraries opened or compiled on every call."""
import ctypes

from torch.utils import cpp_extension


def launch_decode(q, k, v, path):
    lib = ctypes.CDLL(path)                       # JC801 reopened per call
    return lib.ts_paged_decode(q, k, v)


def fused_norm(x):
    mod = cpp_extension.load_inline(              # JC801 compiled per call
        name="norm", cpp_sources="", cuda_sources="")
    return mod.norm(x)


def triton_add(x, y):
    import triton

    @triton.jit                                   # JC801 fresh kernel per call
    def _add(x_ptr, y_ptr, n):
        pass
    return _add
