"""Runtime card-error telemetry for the health prober: the port's copy of
``tpushare/plugin/health.py`` with the card's own error sources.

The reference plugin meant to watch per-device runtime health, but its
XID watcher is commented out (nvidia.go:97-153) and nothing reaches the
health plumbing (server.go:211-229). The plugin's discovery prober
catches a card that vanishes; this module adds the error signal behind
an intact node.

Kept from the original: ``ErrorCounterMonitor`` (a card whose counters
rise is unhealthy at once and recovers after ``recovery_polls`` quiet
polls), ``composite_prober`` with its ``plugin.health_probe`` chaos
point, the ``TPUSHARE_HEALTH_ERRFILES`` override (colon-separated path
templates with ``{index}``; any file whose summed integers rise counts)
and the three serve hooks (``/drain``, ``/mesh/chip``, ``/undrain``).

The card's sources (``CardErrorMonitor``, which ``card_monitor`` builds
for the daemon's backend):

- PCIe AER counters. The JAX defaults, ``/sys/class/accel/accel{index}/
  device/aer_dev_{fatal,nonfatal}``, do not exist for a card; its
  counters sit at its PCI function, ``/sys/bus/pci/devices/<bus id>/
  aer_dev_{fatal,nonfatal}``, the bus id from NVML. Where NVML reports
  none (some virtualized hosts) there is no AER source: logged once, and
  the card stays healthy as far as AER goes. The env override replaces
  these defaults, as it replaces the JAX ones.
- NVML's XID critical-error events (``XidEvents``), the source the
  reference's dead watcher was for. A critical XID counts exactly like a
  counter bump; the XIDs NVIDIA's k8s-device-plugin treats as
  application faults (``APPLICATION_XIDS``) do not count. The event set
  is held under an NVML initialization of its own for the daemon's whole
  life (NVML's init is reference-counted, so a discovery probe's
  shutdown leaves it). Each card registers on its own: where that fails,
  as it may in a container (``NOT_SUPPORTED``), the card is named
  unavailable in the daemon's startup line, and the source is
  unavailable where no card registered. A failed wait (the card lost,
  NVML gone) counts as an XID on every registered card for as long as it
  lasts, as NVIDIA's k8s-device-plugin does: never read as healthy
  forever.
"""

from __future__ import annotations

import json
import logging
import os
import re
import urllib.request
from typing import Callable, Dict, List, Optional, Set, Tuple

from tpushare_torch.chaos import fault_point
from tpushare_torch.plugin.nvmldisc import (EVENT_XID_CRITICAL,
                                            NVML_ERROR_NOT_SUPPORTED, Nvml,
                                            NvmlError, sysfs_pci_id)

log = logging.getLogger("tpushare.health")

# No counter file is named by a card's index: CardErrorMonitor resolves
# the AER counters through each card's PCI bus id.
DEFAULT_ERRFILE_TEMPLATES = ()
ENV_ERRFILES = "TPUSHARE_HEALTH_ERRFILES"
PCI_ROOT = "/sys/bus/pci/devices"
AER_COUNTERS = ("aer_dev_fatal", "aer_dev_nonfatal")
#: XIDs that NVIDIA's k8s-device-plugin skips by default: faults of an
#: application (graphics engine exception, GPU memory page fault, a
#: preemptive cleanup after one, a reset channel, an uncorrectable ECC
#: error contained to the application), not of the card.
APPLICATION_XIDS = frozenset({13, 31, 43, 45, 68})


def _read_counter(path: str) -> Optional[int]:
    """Sum every integer in the file (AER files are "KEY value" lines;
    plain counter files are a bare int). None when unreadable."""
    try:
        with open(path) as f:
            text = f.read()
    except OSError:
        return None
    values = re.findall(r"\b(\d+)\b", text)
    if not values:
        return 0
    return sum(int(v) for v in values)


class ErrorCounterMonitor:
    """Stateful per-chip error-counter watcher.

    ``poll(indices)`` returns {index: healthy}. A chip is unhealthy
    from the first poll where any of its counters increased, until
    ``recovery_polls`` consecutive polls see no further increase.
    Missing counter files are skipped (not every platform exposes
    every source); a chip with no readable counters is always healthy
    from this source (discovery still covers node loss).
    """

    def __init__(self, templates: Optional[List[str]] = None,
                 recovery_polls: int = 3):
        if templates is None:
            env = os.environ.get(ENV_ERRFILES)
            templates = (env.split(":") if env
                         else list(DEFAULT_ERRFILE_TEMPLATES))
        self.templates = templates
        self.recovery_polls = recovery_polls
        self._last: Dict[str, int] = {}      # path -> counter
        self._quiet: Dict[int, int] = {}     # index -> quiet polls left

    def _chip_errors(self, index: int) -> bool:
        bumped = False
        for t in self.templates:
            path = t.format(index=index)
            val = _read_counter(path)
            if val is None:
                continue
            prev = self._last.get(path)
            self._last[path] = val
            if prev is not None and val > prev:
                log.warning("chip %d error counter %s: %d -> %d",
                            index, path, prev, val)
                bumped = True
        return bumped

    def poll(self, indices) -> Dict[int, bool]:
        out = {}
        for index in indices:
            if self._chip_errors(index):
                self._quiet[index] = self.recovery_polls
            elif self._quiet.get(index, 0) > 0:
                self._quiet[index] -= 1
            out[index] = self._quiet.get(index, 0) == 0
        return out


def composite_prober(backend, monitor: Optional[ErrorCounterMonitor] = None
                     ) -> Callable:
    """Discovery AND runtime-error health, by chip uuid.

    A chip is healthy iff discovery still sees it (node present) and
    its error counters are quiet. Replaces server._backend_health_prober
    as the default prober for new_tpu_device_plugin.
    """
    monitor = monitor or ErrorCounterMonitor()
    # Chaos seam (tpushare_torch.chaos): a TPUSHARE_CHAOS spec arming
    # plugin.health_probe makes the probe raise (all chips read
    # unhealthy — device churn) or hang (a wedged probe backend);
    # unarmed, this is the shared no-op.
    _fault = fault_point("plugin.health_probe")

    def probe(topo) -> dict:
        try:
            _fault()
            fresh = backend.health_probe()
            seen = {c.uuid: c.healthy for c in fresh.chips}
        except Exception:
            return {c.uuid: False for c in topo.chips}
        errs = monitor.poll([c.index for c in topo.chips])
        return {c.uuid: bool(seen.get(c.uuid, False)
                             and errs.get(c.index, True))
                for c in topo.chips}

    return probe


class XidEvents:
    """NVML's XID critical-error events for every card, held under an
    NVML initialization of this object's own from construction to
    ``close()``.

    ``status`` says on how many cards the events registered ("registered
    on N card(s)", then "; unavailable on card i: ..." for each card that
    failed) or why on none ("unavailable: ..."); ``drain()`` returns the
    indices of the cards that reported a critical XID since the last
    drain, application XIDs left out, and every registered card when the
    wait failed; ``seen`` keeps every critical (index, xid), ``ignored``
    every application one, ``wait_errors`` counts the failed waits and
    ``last_wait_error`` names the latest."""

    def __init__(self, lib):
        self.seen: List[Tuple[int, int]] = []
        self.ignored: List[Tuple[int, int]] = []
        self.wait_errors = 0
        self.last_wait_error: Optional[str] = None
        self._by_handle: Dict[int, int] = {}
        self._set = None
        self._nv: Optional[Nvml] = None
        nv = Nvml(lib)
        try:
            nv.__enter__()
        except NvmlError as e:
            self.status = f"unavailable: {e}"
            return
        self._nv = nv
        missing: List[str] = []
        try:
            self._set = nv.event_set()
            for index in range(nv.count()):
                h = nv.handle(index)
                try:
                    if not nv.supported_events(h) & EVENT_XID_CRITICAL:
                        raise NvmlError("nvmlDeviceGetSupportedEventTypes",
                                        NVML_ERROR_NOT_SUPPORTED,
                                        "no XID critical-error events")
                    nv.register_events(h, EVENT_XID_CRITICAL, self._set)
                except NvmlError as e:
                    missing.append(f"card {index}: {e}")
                    continue
                self._by_handle[h.value] = index
        except NvmlError as e:
            missing.append(str(e))
        if not self._by_handle:
            self.status = "unavailable: " + "; ".join(missing or ["no card"])
            self.close()
            return
        self.status = f"registered on {len(self._by_handle)} card(s)"
        if missing:
            self.status += "; unavailable on " + "; ".join(missing)

    @property
    def available(self) -> bool:
        return self._set is not None

    def drain(self) -> Set[int]:
        bumped: Set[int] = set()
        while self._set is not None:
            try:
                data = self._nv.wait_event(self._set, 0)
            except NvmlError as e:
                # Every XID after a failed wait is lost to this source:
                # count the failure on every registered card.
                log.warning("XID event wait failed: %s (every card "
                            "counted as bumped)", e)
                self.wait_errors += 1
                self.last_wait_error = str(e)
                bumped.update(self._by_handle.values())
                break
            if data is None:
                break
            if data.eventType != EVENT_XID_CRITICAL:
                continue
            xid, index = int(data.eventData), self._by_handle[data.device]
            if xid in APPLICATION_XIDS:
                log.info("card %d XID %d: an application fault, not "
                         "counted", index, xid)
                self.ignored.append((index, xid))
            else:
                log.warning("card %d critical XID %d", index, xid)
                self.seen.append((index, xid))
                bumped.add(index)
        return bumped

    def close(self) -> None:
        if self._set is not None:
            self._nv.free_event_set(self._set)
            self._set = None
        if self._nv is not None:
            self._nv.__exit__(None, None, None)
            self._nv = None

    def __del__(self):
        self.close()


class CardErrorMonitor(ErrorCounterMonitor):
    """``ErrorCounterMonitor`` over a card's sources: the template
    counters (the env override), each card's AER counters at its PCI
    function and NVML's critical XIDs, each bumping a card alike.
    ``lib`` is the NVML library object behind the daemon's backend, None
    where there is none (the fake backend): then only the env's counters
    and discovery speak."""

    def __init__(self, lib=None, templates: Optional[List[str]] = None,
                 recovery_polls: int = 3, pci_root: str = PCI_ROOT):
        override = templates is not None or bool(os.environ.get(ENV_ERRFILES))
        super().__init__(templates, recovery_polls)
        self._aer: Dict[int, List[str]] = {}
        self._xid_bumped: Set[int] = set()
        self.xid: Optional[XidEvents] = None
        if lib is None:
            self.aer_status = "unavailable: no NVML behind this backend"
            self.xid_status = "unavailable: no NVML behind this backend"
            return
        if override:
            self.aer_status = f"replaced by {ENV_ERRFILES}"
        else:
            self.aer_status = self._resolve_aer(lib, pci_root)
            log.info("AER counters: %s", self.aer_status)
        self.xid = XidEvents(lib)
        self.xid_status = self.xid.status
        if "unavailable" in self.xid_status:
            log.warning("XID source %s", self.xid_status)

    def _resolve_aer(self, lib, pci_root: str) -> str:
        missing = []
        try:
            with Nvml(lib) as nv:
                for index in range(nv.count()):
                    pci = sysfs_pci_id(nv.pci_bus_id(nv.handle(index)) or "")
                    paths = [os.path.join(pci_root, pci, name)
                             for name in AER_COUNTERS] if pci else []
                    # Escaped: the copied loop formats them as templates.
                    paths = [p.replace("{", "{{").replace("}", "}}")
                             for p in paths if os.path.exists(p)]
                    if paths:
                        self._aer[index] = paths
                    else:
                        missing.append(index)
        except NvmlError as e:
            return f"unavailable: {e}"
        if missing:
            log.warning("no AER counters for card(s) %s: NVML reports no "
                        "PCI bus id, or the function has no aer_dev_* "
                        "files (they stay healthy as far as AER goes)",
                        missing)
        if not self._aer:
            return "unavailable: no PCI bus id or aer_dev_* file"
        return f"{sum(map(len, self._aer.values()))} file(s) on " \
               f"{len(self._aer)} card(s)"

    def describe(self) -> str:
        counters = ":".join(self.templates) or "none"
        return (f"counters={counters}; aer={self.aer_status}; "
                f"xid={self.xid_status}")

    def poll(self, indices) -> Dict[int, bool]:
        self._xid_bumped = self.xid.drain() if self.xid is not None else set()
        return super().poll(indices)

    def _chip_errors(self, index: int) -> bool:
        # The copied loop reads this card's AER paths beside the
        # templates.
        templates = self.templates
        self.templates = [*templates, *self._aer.get(index, ())]
        try:
            bumped = super()._chip_errors(index)
        finally:
            self.templates = templates
        return bumped or index in self._xid_bumped

    def close(self) -> None:
        if self.xid is not None:
            self.xid.close()


def card_monitor(backend) -> CardErrorMonitor:
    """The health monitor for a daemon's backend: over NVML's library
    where the backend discovers through NVML (alone, or first in the
    ``torch`` chain), else (the fake) without NVML."""
    members = getattr(backend, "backends", [backend])
    nvml = next((b for b in members if b.name == "nvml"), None)
    if nvml is None:
        return CardErrorMonitor()
    return CardErrorMonitor(nvml.library(), pci_root=nvml.pci_root)


ENV_DRAIN_URL = "TPUSHARE_DRAIN_URL"


def serve_drain_hook(url: Optional[str] = None,
                     timeout_s: float = 2.0) -> Optional[Callable]:
    """Tenant-side half of device-health churn: a hook for the
    plugin's unhealthy transition that POSTs the serve daemon's
    ``/drain`` endpoint, so a pod sitting on a chip the plugin just
    withdrew stops accepting new requests and finishes what it has
    (cli/serve.py begin_drain) instead of racing fresh admissions onto
    dying silicon.

    ``url``: the daemon's drain endpoint (default from the
    TPUSHARE_DRAIN_URL env var, e.g. ``http://127.0.0.1:8478/drain``);
    returns None when neither is set — the plugin then runs without a
    co-located daemon to notify. The returned callable takes the
    unhealthy chip's uuid and never raises (a dead daemon must not
    take the health loop down with it — the failed push is logged and
    counted by the caller's metrics)."""
    url = url or os.environ.get(ENV_DRAIN_URL)
    if not url:
        return None

    def push(chip_uuid: str) -> bool:
        req = urllib.request.Request(
            url, data=b"{}", method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                body = json.loads(resp.read() or b"{}")
            log.info("churn push for chip %s -> %s %s (%s)", chip_uuid,
                     url, resp.status, body.get("state"))
            return True
        except Exception as e:
            log.error("churn push for chip %s to %s failed: %s",
                      chip_uuid, url, e)
            return False

    return push


def serve_chip_health_hook(topo, url: Optional[str] = None,
                           timeout_s: float = 2.0) -> Optional[Callable]:
    """Per-CHIP churn hook for the plugin's unhealthy transition — the
    mesh-failure-domain refinement of serve_drain_hook: instead of
    draining the whole co-located daemon, POST the chip's identity to
    the engine's ``/mesh/chip`` endpoint so a SHARDED engine can
    degrade onto its surviving chips (cli/serve.py chip_event) while
    an unsharded engine keeps the old drain behavior (the endpoint
    falls back to it — one chip IS that engine's whole domain).

    ``topo`` resolves the hook's chip uuid to the plugin's chip INDEX
    (the TPU_VISIBLE_CHIPS vocabulary; the engine maps index ->
    granted device position). The endpoint derives from the same
    TPUSHARE_DRAIN_URL contract (``.../drain`` -> ``.../mesh/chip``);
    None when the env/url is unset or underivable — the plugin then
    runs with the plain drain hook (build_plugin wires the fallback).

    Recovery stays on serve_undrain_hook: the plugin's on_healthy
    fires only once ALL chips are healthy, and /undrain is exactly
    the engine's all-clear (mark every device healthy, grow back at
    the next idle tick)."""
    url = url or os.environ.get(ENV_DRAIN_URL)
    if not url:
        return None
    if not url.rstrip("/").endswith("/drain"):
        log.warning(
            "%s=%r does not end in /drain: cannot derive the "
            "/mesh/chip endpoint for per-chip health churn (falling "
            "back to whole-daemon drain semantics)",
            ENV_DRAIN_URL, url)
        return None
    base = url.rstrip("/")[: -len("/drain")]
    chip_url = base + "/mesh/chip"
    by_uuid = {c.uuid: c.index for c in topo.chips}

    def push(chip_uuid: str) -> bool:
        idx = by_uuid.get(chip_uuid)
        if idx is None:
            log.error("chip churn push: unknown chip uuid %s "
                      "(topology drifted?)", chip_uuid)
            return False
        body = json.dumps({"chip": idx, "healthy": False}).encode()
        req = urllib.request.Request(
            chip_url, data=body, method="POST",
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=timeout_s) as resp:
                out = json.loads(resp.read() or b"{}")
            log.info("chip churn push for chip %s (index %d) -> %s %s "
                     "(mesh=%s state=%s)", chip_uuid, idx, chip_url,
                     resp.status, out.get("mesh"), out.get("state"))
            return True
        except Exception as e:
            log.error("chip churn push for chip %s to %s failed: %s",
                      chip_uuid, chip_url, e)
            return False

    return push


def serve_undrain_hook(url: Optional[str] = None,
                       timeout_s: float = 2.0) -> Optional[Callable]:
    """Recovery twin of serve_drain_hook: when every chip is healthy
    again the plugin POSTs the sibling ``/undrain`` endpoint (derived
    from the same TPUSHARE_DRAIN_URL), so the replica REJOINS service
    — a drain with no undrain path would turn one transient counter
    blip into a permanently lost replica behind a green /healthz.
    None when the url/env is unset or does not end in ``/drain`` —
    the latter is WARNED loudly: a drain hook wired without its
    recovery twin IS the one-way-drain failure mode."""
    url = url or os.environ.get(ENV_DRAIN_URL)
    if not url:
        return None
    if not url.rstrip("/").endswith("/drain"):
        log.warning(
            "%s=%r does not end in /drain: the drain hook is wired "
            "but NO undrain hook can be derived — a recovered chip "
            "will never rejoin this replica to service (use a .../"
            "drain URL, or wire on_healthy explicitly)",
            ENV_DRAIN_URL, url)
        return None
    base = url.rstrip("/")[: -len("/drain")]
    return serve_drain_hook(base + "/undrain", timeout_s=timeout_s)
