"""JC801 fixture — negatives: builds kept in a module-level table, on
self, or behind a memoized factory."""
import ctypes
import functools

_libs = {}


def load(name, path):
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(path)
        _libs[name] = lib
    return lib


@functools.lru_cache(maxsize=None)
def add_kernel():
    import triton

    @triton.jit
    def _add(x_ptr, y_ptr, n):
        pass
    return _add


class Nvml:
    def library(self, path):
        if self._lib is None:
            self._lib = ctypes.CDLL(path)
        return self._lib
