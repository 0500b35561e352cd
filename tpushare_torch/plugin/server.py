"""The device-plugin gRPC server and kubelet registration: the port's
copy of ``tpushare/plugin/server.py`` (the reference plugin's
server.go): serve deviceplugin/v1beta1 on a unix socket in the kubelet's
device-plugin dir, self-dial to confirm it (server.go:131), register with
the kubelet (server.go:158-177), stream the fake device list through
ListAndWatch and re-send it on health transitions (server.go:180-193).

Kept from the JAX package over the reference: GetPreferredAllocation
(best-fit packing, ``topology.preferred_fake_devices``; the reference
panics), recoverable health (the reference's FIXME, server.go:188) and a
pluggable, wired health prober.

One definition changes: ``new_tpu_device_plugin`` hands
``composite_prober`` the card's monitor (``health.card_monitor``: AER
counters by PCI bus id and NVML's XID events) and logs its sources in
the daemon's startup lines. Allocate's device specs (``/dev/nvidia<minor>``,
``/dev/nvidiactl``, ``/dev/nvidia-uvm*``) come from the port's
``Allocator`` over ``NvmlBackend``'s topology.
"""

from __future__ import annotations

import logging
import os
import threading
from concurrent import futures
from typing import Callable, Optional

import grpc

from tpushare_torch import deviceplugin as dp
from tpushare_torch.deviceplugin import pb
from tpushare_torch.k8s import events
from tpushare_torch.k8s.client import KubeClient
from tpushare_torch.k8s.events import EventRecorder
from tpushare_torch.k8s.kubelet import KubeletClient
from tpushare_torch.plugin import const
from tpushare_torch.plugin.allocate import Allocator
from tpushare_torch.plugin.backend import Backend, HostTopology
from tpushare_torch.plugin.devices import DeviceMap, expand_devices, mark_healthy, mark_unhealthy
from tpushare_torch.plugin.metrics import REGISTRY as METRICS
from tpushare_torch.plugin.podmanager import PodManager
from tpushare_torch.plugin.topology import preferred_fake_devices

log = logging.getLogger("tpushare.server")


def dial(socket_path: str, timeout: float = 5.0) -> grpc.Channel:
    """Blocking unix-socket dial (reference: dial, server.go:98-111)."""
    channel = grpc.insecure_channel(f"unix:{socket_path}")
    grpc.channel_ready_future(channel).result(timeout=timeout)
    return channel


class TpuDevicePlugin(dp.DevicePluginServicer):
    """Implements v1beta1.DevicePlugin for the tpu-mem resource."""

    def __init__(self, devmap: DeviceMap, topo: HostTopology,
                 allocator: Allocator,
                 socket_path: Optional[str] = None,
                 device_plugin_path: str = dp.DEVICE_PLUGIN_PATH,
                 health_prober: Optional[Callable[[HostTopology], dict]] = None,
                 health_interval: float = 5.0,
                 recorder=None,
                 on_unhealthy: Optional[Callable[[str], None]] = None,
                 on_healthy: Optional[Callable[[str], None]] = None):
        self._lock = threading.Lock()
        self.devmap = devmap
        self.topo = topo
        self.allocator = allocator
        self.device_plugin_path = device_plugin_path
        self.socket_path = socket_path or os.path.join(
            device_plugin_path, const.SERVER_SOCK_NAME)
        self._server: Optional[grpc.Server] = None
        self._stop = threading.Event()
        # ListAndWatch fan-out: version bump + condition wakes all streams.
        self._version = 0
        self._cond = threading.Condition()
        self._health_prober = health_prober
        self._health_interval = health_interval
        self._health_thread: Optional[threading.Thread] = None
        self.recorder = recorder
        # Device-health churn, tenant side: on_unhealthy is called
        # with the chip uuid on every unhealthy transition —
        # health.serve_drain_hook plugs in here to push a drain into
        # a co-located serve daemon, so its in-flight streams finish
        # while the scheduler stops placing new work on the dying
        # chip. on_healthy fires on a recovery transition ONLY once
        # every device is healthy again (an /undrain while a second
        # chip is still bad would rejoin service too early); drains
        # must not be one-way or a transient counter blip would take
        # the replica out of service forever behind a green /healthz.
        self.on_unhealthy = on_unhealthy
        self.on_healthy = on_healthy

    # -- device list mutation ------------------------------------------------
    def _bump(self) -> None:
        with self._cond:
            self._version += 1
            self._cond.notify_all()

    def set_chip_health(self, chip_uuid: str, healthy: bool) -> None:
        with self._lock:
            self.devmap = (mark_healthy if healthy else mark_unhealthy)(
                self.devmap, chip_uuid)
            self.allocator.devmap = self.devmap  # keep Allocate's view current
            all_healthy = all(d.health == dp.HEALTHY
                              for d in self.devmap.devices)
        self._bump()
        # Hooks run outside the lock: they do I/O (a drain/undrain
        # POST to the co-located daemon) and must never stall
        # ListAndWatch. Undrain only once EVERY device is healthy.
        hook = (self.on_healthy if healthy and all_healthy
                else self.on_unhealthy if not healthy else None)
        if hook is not None:
            try:
                hook(chip_uuid)
            except Exception as e:
                METRICS.inc("tpushare_drain_hook_errors_total")
                log.error("health-churn hook failed for chip %s: %s",
                          chip_uuid, e)

    def _health_loop(self) -> None:
        """Poll the prober; prober returns {chip_uuid: healthy_bool}
        (the working replacement for the reference's commented-out
        watchXIDs, nvidia.go:97-153)."""
        current = {c.uuid: c.healthy for c in self.topo.chips}
        while not self._stop.wait(self._health_interval):
            try:
                states = self._health_prober(self.topo)
            except Exception as e:
                # Counted, not just logged (CC203): a prober that
                # fails every poll leaves chip health frozen at its
                # last known state — operators alert on this counter.
                METRICS.inc("tpushare_health_probe_errors_total")
                log.warning("health prober failed: %s", e)
                continue
            for uuid, healthy in (states or {}).items():
                if current.get(uuid) != healthy:
                    log.info("chip %s health -> %s", uuid, healthy)
                    current[uuid] = healthy
                    self.set_chip_health(uuid, healthy)
                    METRICS.set("tpushare_chips_healthy",
                                sum(current.values()))
                    if self.recorder is not None:
                        if healthy:
                            self.recorder.node_event(
                                events.REASON_CHIP_RECOVERED,
                                f"TPU chip {uuid} recovered")
                        else:
                            self.recorder.node_event(
                                events.REASON_CHIP_UNHEALTHY,
                                f"TPU chip {uuid} reported unhealthy "
                                f"(withdrawn from schedulable devices)",
                                "Warning")

    # -- gRPC methods ----------------------------------------------------------
    def GetDevicePluginOptions(self, request, context):
        return pb.DevicePluginOptions(get_preferred_allocation_available=True)

    def ListAndWatch(self, request, context):
        """Send the full list immediately, then re-send on every health
        transition (server.go:180-193)."""
        with self._cond:
            version = self._version
        with self._lock:  # snapshot only; never yield while holding the lock
            devices = list(self.devmap.devices)
        yield pb.ListAndWatchResponse(devices=devices)
        while not self._stop.is_set():
            with self._cond:
                self._cond.wait_for(
                    lambda: self._version != version or self._stop.is_set(),
                    timeout=1.0)
                changed = self._version != version
                version = self._version
            if self._stop.is_set():
                return
            if changed:
                with self._lock:
                    devices = list(self.devmap.devices)
                yield pb.ListAndWatchResponse(devices=devices)

    def GetPreferredAllocation(self, request, context):
        resp = pb.PreferredAllocationResponse()
        with self._lock:
            devmap, topo = self.devmap, self.topo
        for creq in request.container_requests:
            picked = preferred_fake_devices(
                devmap, topo,
                list(creq.available_deviceIDs),
                list(creq.must_include_deviceIDs),
                creq.allocation_size)
            resp.container_responses.add(deviceIDs=picked)
        return resp

    def Allocate(self, request, context):
        return self.allocator.allocate(request)

    def PreStartContainer(self, request, context):
        return pb.PreStartContainerResponse()  # no-op (server.go:199-201)

    # -- lifecycle -------------------------------------------------------------
    def _cleanup(self) -> None:
        try:
            os.remove(self.socket_path)
        except FileNotFoundError:
            pass

    def start(self) -> None:
        """Serve on the unix socket, then self-dial to confirm
        (server.go:114-142)."""
        self._cleanup()
        self._stop.clear()
        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=8))
        dp.add_DevicePluginServicer_to_server(self, self._server)
        self._server.add_insecure_port(f"unix:{self.socket_path}")
        self._server.start()
        dial(self.socket_path, timeout=5.0).close()
        if self._health_prober is not None:
            self._health_thread = threading.Thread(
                target=self._health_loop, name="tpushare-health", daemon=True)
            self._health_thread.start()

    def stop(self) -> None:
        """Stop serving and remove the socket (server.go:145-155)."""
        # /healthz must go not-ready the moment the plugin stops —
        # otherwise a wedge during re-registration reports healthy.
        METRICS.ready = False
        self._stop.set()
        self._bump()
        if self._server is not None:
            self._server.stop(grace=0.5).wait()
            self._server = None
        if self._health_thread is not None:
            self._health_thread.join(timeout=2 * self._health_interval)
            self._health_thread = None
        self._cleanup()

    def register(self, kubelet_socket: Optional[str] = None,
                 resource_name: str = const.RESOURCE_NAME) -> None:
        """Announce ourselves on the kubelet's Registration service
        (server.go:158-177)."""
        kubelet_socket = kubelet_socket or os.path.join(
            self.device_plugin_path, "kubelet.sock")
        channel = dial(kubelet_socket, timeout=5.0)
        try:
            stub = dp.RegistrationStub(channel)
            stub.Register(pb.RegisterRequest(
                version=dp.VERSION,
                endpoint=os.path.basename(self.socket_path),
                resource_name=resource_name,
                options=pb.DevicePluginOptions(
                    get_preferred_allocation_available=True),
            ))
        finally:
            channel.close()

    def serve(self) -> None:
        """start + register, stopping on registration failure
        (server.go:232-249)."""
        self.start()
        log.info("starting to serve on %s", self.socket_path)
        try:
            self.register()
        except Exception:
            self.stop()
            raise
        log.info("registered device plugin with kubelet")
        # Gauges BEFORE ready: a scraper that sees /healthz 200 must
        # also see the inventory gauges populated.
        METRICS.inc("tpushare_plugin_registrations_total")
        METRICS.set("tpushare_mem_units_advertised",
                    len(self.devmap.devices))
        chips = self.topo.chips
        METRICS.set("tpushare_chips_total", len(chips))
        METRICS.set("tpushare_chips_healthy",
                    sum(1 for c in chips if c.healthy))
        METRICS.ready = True


def new_tpu_device_plugin(backend: Backend, kube: KubeClient, node_name: str,
                          memory_unit: str = const.GIB,
                          kubelet: Optional[KubeletClient] = None,
                          query_kubelet: bool = False,
                          health_check: bool = False,
                          device_plugin_path: str = dp.DEVICE_PLUGIN_PATH,
                          socket_path: Optional[str] = None,
                          device_nodes: bool = True) -> TpuDevicePlugin:
    """Probe + expand + patch node resources + wire the allocator
    (reference: NewNvidiaDevicePlugin, server.go:43-78)."""
    topo = backend.probe()
    devmap = expand_devices(topo, memory_unit)
    log.info("device map: %s", devmap.uuid_to_index)
    podmgr = PodManager(kube, node_name, kubelet=kubelet,
                        query_kubelet=query_kubelet)
    podmgr.patch_chip_resources(topo.chip_count, topo.total_cores)
    podmgr.publish_topology(topo)
    disable_isolation = podmgr.disable_isolation_or_not()
    recorder = EventRecorder(kube, node_name)
    allocator = Allocator(devmap, topo, podmgr, kube,
                          disable_isolation=disable_isolation,
                          recorder=recorder,
                          device_nodes=device_nodes)
    if health_check:
        # Discovery (node present) AND the card's runtime errors (AER
        # counters, NVML's critical XIDs: a wedged card behind an intact
        # node, the failure the reference's dead XID watcher was for).
        from tpushare_torch.plugin.health import (card_monitor,
                                                  composite_prober)
        monitor = card_monitor(backend)
        log.info("health sources: %s", monitor.describe())
        prober = composite_prober(backend, monitor)
    else:
        prober = None
    # TPUSHARE_DRAIN_URL set -> unhealthy chips push PER-CHIP health
    # into the co-located serve daemon (/mesh/chip: a sharded engine
    # degrades onto its surviving chips — the mesh failure domain —
    # while an unsharded engine drains exactly as before), and full
    # recovery pushes the matching undrain (the engine's all-clear:
    # grow back to the configured mesh at the next idle tick). The
    # plain drain hook is the fallback when no /mesh/chip endpoint is
    # derivable from the URL.
    from tpushare_torch.plugin.health import (serve_chip_health_hook,
                                              serve_drain_hook,
                                              serve_undrain_hook)
    return TpuDevicePlugin(devmap, topo, allocator,
                           socket_path=socket_path,
                           device_plugin_path=device_plugin_path,
                           health_prober=prober,
                           recorder=recorder,
                           on_unhealthy=(serve_chip_health_hook(topo)
                                         or serve_drain_hook()),
                           on_healthy=serve_undrain_hook())


def _backend_health_prober(backend: Backend) -> Callable[[HostTopology], dict]:
    """A chip that disappears from discovery (its /dev/accelN node is
    gone) is *unhealthy*, not merely absent; a failed probe (all nodes
    gone) marks every known chip unhealthy."""
    def probe(topo: HostTopology) -> dict:
        try:
            fresh = backend.health_probe()
        except Exception:
            return {c.uuid: False for c in topo.chips}
        seen = {c.uuid: c.healthy for c in fresh.chips}
        return {c.uuid: seen.get(c.uuid, False) for c in topo.chips}
    return probe
