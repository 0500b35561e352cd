"""Card discovery through NVML: ``libnvidia-ml.so.1`` loaded with ctypes.

The port's counterpart of ``tpushare/plugin/libtpudisc.py`` and
``nativedisc.py`` (a native library behind a ``Backend``), and the
reference plugin's L1 (its ``go-nvml`` calls, nvidia.go:44-86). NVML makes
no CUDA context, so the daemon can probe beside running tenants.

Calls, in order: ``nvmlInit_v2``, ``nvmlDeviceGetCount_v2``, and per card
``nvmlDeviceGetHandleByIndex_v2``, ``nvmlDeviceGetUUID``,
``nvmlDeviceGetName``, ``nvmlDeviceGetMemoryInfo``,
``nvmlDeviceGetMinorNumber``, ``nvmlDeviceGetPciInfo_v3`` (its bus id
finds the NUMA node under ``/sys/bus/pci/devices/<busid>/numa_node``; a
card whose bus id NVML does not report, as on some virtualized hosts,
gets NUMA node 0), then ``nvmlShutdown``. Any other failed call raises
``NvmlError``.

The health watch's XID source (``plugin/health.py``) adds NVML's event
calls: ``nvmlEventSetCreate``, ``nvmlDeviceGetSupportedEventTypes``,
``nvmlDeviceRegisterEvents`` (``nvmlEventTypeXidCriticalError``),
``nvmlEventSetWait_v2`` (``NVML_ERROR_TIMEOUT``: no event) and
``nvmlEventSetFree``.

``Nvml`` is the thin typed layer over the library; tests inject a fake
object with the same C call surface (pointer arguments written through
``.contents``, string buffers through ``.value``).
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Tuple

from tpushare_torch.plugin.backend import (NVIDIA_SHARED_NODES, Backend,
                                           HostTopology, _read_int,
                                           build_topology_from_facts,
                                           generation_from_name)

LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_ERROR_TIMEOUT = 10
#: ``nvmlEventTypeXidCriticalError``
EVENT_XID_CRITICAL = 0x8
_BUF = 96                                # NVML_DEVICE_UUID_V2_BUFFER_SIZE


class NvmlMemory(ctypes.Structure):
    """``nvmlMemory_t``."""
    _fields_ = [("total", ctypes.c_ulonglong), ("free", ctypes.c_ulonglong),
                ("used", ctypes.c_ulonglong)]


class NvmlPciInfo(ctypes.Structure):
    """``nvmlPciInfo_t`` (the ``_v3`` call's layout)."""
    _fields_ = [("busIdLegacy", ctypes.c_char * 16),
                ("domain", ctypes.c_uint), ("bus", ctypes.c_uint),
                ("device", ctypes.c_uint), ("pciDeviceId", ctypes.c_uint),
                ("pciSubSystemId", ctypes.c_uint),
                ("busId", ctypes.c_char * 32)]


class NvmlProcessInfo(ctypes.Structure):
    """``nvmlProcessInfo_t`` (the ``_v3`` running-process call's)."""
    _fields_ = [("pid", ctypes.c_uint), ("usedGpuMemory", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


class NvmlError(RuntimeError):
    def __init__(self, call: str, rc: int, text: str = ""):
        super().__init__(f"{call} failed: NVML error {rc}"
                         + (f" ({text})" if text else ""))
        self.call, self.rc = call, rc


_HANDLE = ctypes.c_void_p
_EVENT_SET = ctypes.c_void_p


class NvmlEventData(ctypes.Structure):
    """``nvmlEventData_t``."""
    _fields_ = [("device", _HANDLE), ("eventType", ctypes.c_ulonglong),
                ("eventData", ctypes.c_ulonglong),
                ("gpuInstanceId", ctypes.c_uint),
                ("computeInstanceId", ctypes.c_uint)]


_SIGNATURES = {
    "nvmlInit_v2": [],
    "nvmlShutdown": [],
    "nvmlDeviceGetCount_v2": [ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetHandleByIndex_v2": [ctypes.c_uint,
                                      ctypes.POINTER(_HANDLE)],
    "nvmlDeviceGetUUID": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetName": [_HANDLE, ctypes.c_char_p, ctypes.c_uint],
    "nvmlDeviceGetMemoryInfo": [_HANDLE, ctypes.POINTER(NvmlMemory)],
    "nvmlDeviceGetMinorNumber": [_HANDLE, ctypes.POINTER(ctypes.c_uint)],
    "nvmlDeviceGetPciInfo_v3": [_HANDLE, ctypes.POINTER(NvmlPciInfo)],
    "nvmlDeviceGetComputeRunningProcesses_v3": [
        _HANDLE, ctypes.POINTER(ctypes.c_uint),
        ctypes.POINTER(NvmlProcessInfo)],
    "nvmlEventSetCreate": [ctypes.POINTER(_EVENT_SET)],
    "nvmlDeviceGetSupportedEventTypes": [_HANDLE,
                                         ctypes.POINTER(ctypes.c_ulonglong)],
    "nvmlDeviceRegisterEvents": [_HANDLE, ctypes.c_ulonglong, _EVENT_SET],
    "nvmlEventSetWait_v2": [_EVENT_SET, ctypes.POINTER(NvmlEventData),
                            ctypes.c_uint],
    "nvmlEventSetFree": [_EVENT_SET],
}


def load_library(name: str = LIBRARY) -> ctypes.CDLL:
    """The NVML shared library with every call this module makes typed;
    raises OSError where libnvidia-ml is absent."""
    lib = ctypes.CDLL(name)
    for fn, args in _SIGNATURES.items():
        f = getattr(lib, fn, None)
        if f is not None:
            f.argtypes = args
            f.restype = ctypes.c_int
    err = getattr(lib, "nvmlErrorString", None)
    if err is not None:
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
    return lib


def sysfs_pci_id(bus_id: str) -> Optional[str]:
    """NVML's ``"00000000:18:00.0"`` -> sysfs's ``"0000:18:00.0"``; None
    when the bus id is not of that form."""
    dom, sep, rest = bus_id.strip().partition(":")
    if not sep or not rest:
        return None
    try:
        return f"{int(dom, 16):04x}:{rest.lower()}"
    except ValueError:
        return None


class Nvml:
    """Typed calls over an NVML library object (``load_library()`` or a
    fake with the same C surface). A context manager: init on enter,
    shutdown on exit."""

    def __init__(self, lib):
        self.lib = lib

    def _check(self, call: str, rc: int) -> None:
        if rc != NVML_SUCCESS:
            err = getattr(self.lib, "nvmlErrorString", None)
            text = err(rc) if err is not None else b""
            raise NvmlError(call, rc, (text or b"").decode(errors="replace"))

    def __enter__(self) -> "Nvml":
        self._check("nvmlInit_v2", self.lib.nvmlInit_v2())
        return self

    def __exit__(self, *exc) -> None:
        self.lib.nvmlShutdown()

    def count(self) -> int:
        n = ctypes.c_uint()
        self._check("nvmlDeviceGetCount_v2",
                    self.lib.nvmlDeviceGetCount_v2(ctypes.pointer(n)))
        return n.value

    def handle(self, index: int):
        h = _HANDLE()
        self._check("nvmlDeviceGetHandleByIndex_v2",
                    self.lib.nvmlDeviceGetHandleByIndex_v2(
                        index, ctypes.pointer(h)))
        return h

    def _text(self, call: str, h) -> str:
        buf = ctypes.create_string_buffer(_BUF)
        self._check(call, getattr(self.lib, call)(h, buf, _BUF))
        return buf.value.decode()

    def uuid(self, h) -> str:
        return self._text("nvmlDeviceGetUUID", h)

    def name(self, h) -> str:
        return self._text("nvmlDeviceGetName", h)

    def memory(self, h) -> Tuple[int, int, int]:
        """(total, free, used) bytes."""
        m = NvmlMemory()
        self._check("nvmlDeviceGetMemoryInfo",
                    self.lib.nvmlDeviceGetMemoryInfo(h, ctypes.pointer(m)))
        return m.total, m.free, m.used

    def minor(self, h) -> int:
        n = ctypes.c_uint()
        self._check("nvmlDeviceGetMinorNumber",
                    self.lib.nvmlDeviceGetMinorNumber(h, ctypes.pointer(n)))
        return n.value

    def pci_bus_id(self, h) -> Optional[str]:
        """The card's bus id, or None where NVML reports none."""
        p = NvmlPciInfo()
        if self.lib.nvmlDeviceGetPciInfo_v3(h, ctypes.pointer(p)) \
                != NVML_SUCCESS:
            return None
        return p.busId.decode(errors="replace") or None

    def processes(self, h, cap: int = 64) -> List[Tuple[int, int]]:
        """(pid, used bytes) of each compute process on the card, as NVML
        numbers them (in a PID namespace they are not this host's)."""
        n = ctypes.c_uint(cap)
        arr = (NvmlProcessInfo * cap)()
        self._check("nvmlDeviceGetComputeRunningProcesses_v3",
                    self.lib.nvmlDeviceGetComputeRunningProcesses_v3(
                        h, ctypes.pointer(n), arr))
        return [(arr[i].pid, arr[i].usedGpuMemory) for i in range(n.value)]

    def event_set(self):
        """A new event set (free it with ``free_event_set``)."""
        s = _EVENT_SET()
        self._check("nvmlEventSetCreate",
                    self.lib.nvmlEventSetCreate(ctypes.pointer(s)))
        return s

    def supported_events(self, h) -> int:
        """The event types the card can report (a bit mask)."""
        n = ctypes.c_ulonglong()
        self._check("nvmlDeviceGetSupportedEventTypes",
                    self.lib.nvmlDeviceGetSupportedEventTypes(
                        h, ctypes.pointer(n)))
        return n.value

    def register_events(self, h, types: int, event_set) -> None:
        self._check("nvmlDeviceRegisterEvents",
                    self.lib.nvmlDeviceRegisterEvents(h, types, event_set))

    def wait_event(self, event_set,
                   timeout_ms: int = 0) -> Optional[NvmlEventData]:
        """The next event of the set, or None when none came within
        ``timeout_ms`` (``NVML_ERROR_TIMEOUT``)."""
        data = NvmlEventData()
        rc = self.lib.nvmlEventSetWait_v2(event_set, ctypes.pointer(data),
                                          timeout_ms)
        if rc == NVML_ERROR_TIMEOUT:
            return None
        self._check("nvmlEventSetWait_v2", rc)
        return data

    def free_event_set(self, event_set) -> None:
        self.lib.nvmlEventSetFree(event_set)


class NvmlBackend(Backend):
    """Discover the host's cards through NVML. ``lib`` injects a library
    object (tests); ``dev_root`` / ``pci_root`` locate the device nodes
    and the PCI sysfs tree."""

    name = "nvml"

    def __init__(self, lib=None, dev_root: str = "/dev",
                 pci_root: str = "/sys/bus/pci/devices"):
        self._lib = lib
        self._dev_root = dev_root
        self._pci_root = pci_root

    @property
    def pci_root(self) -> str:
        return self._pci_root

    def library(self):
        if self._lib is None:
            self._lib = load_library()
        return self._lib

    def available(self) -> bool:
        try:
            self.library()
        except OSError:
            return False
        return True

    def probe(self) -> HostTopology:
        indices, numa, hbm, uuids, paths, names = [], [], [], [], [], []
        with Nvml(self.library()) as nv:
            count = nv.count()
            if count == 0:
                raise RuntimeError("NVML reports no GPU on this host")
            for i in range(count):
                h = nv.handle(i)
                indices.append(i)
                uuids.append(nv.uuid(h))
                names.append(nv.name(h))
                hbm.append(nv.memory(h)[0])
                paths.append(os.path.join(self._dev_root,
                                          f"nvidia{nv.minor(h)}"))
                pci = sysfs_pci_id(nv.pci_bus_id(h) or "")
                numa.append(_read_int(os.path.join(
                    self._pci_root, pci, "numa_node")) if pci else 0)
        shared = [os.path.join(self._dev_root, n)
                  for n in NVIDIA_SHARED_NODES
                  if os.path.exists(os.path.join(self._dev_root, n))]
        return build_topology_from_facts(
            indices, numa, hbm, uuids, generation_from_name(names[0]),
            device_paths=paths, shared_device_paths=shared)
