"""Daemon lifecycle, discovery wait loop, restart loop, watchers, signals:
the port's copy of ``tpushare/plugin/manager.py`` (the reference
plugin's gpumanager.go).

When the kubelet restarts it recreates ``kubelet.sock``, which triggers
a full re-register (gpumanager.go:84-87). SIGHUP restarts; SIGQUIT dumps
every thread's stack; INT/TERM stop cleanly. Discovery goes through the
port's ``auto_backend``: NVML, or ``FakeBackend`` only when
``TPUSHARE_FAKE_CHIPS`` or ``--backend fake`` asks for it. With neither a
card nor a fake the loop polls and logs (the reference blocks forever,
gpumanager.go:39,46); it never answers from a fake on its own.

Re-registration is retried with exponential backoff: a kubelet restart
recreates the socket before its Registration service answers. Only the
first boot raises on failure, so a misconfigured daemon crashes loudly.
The ``plugin.kubelet_restart`` chaos point injects the restart event.
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import threading
import time
from typing import Optional

from tpushare_torch import deviceplugin as dp
from tpushare_torch.chaos import InjectedFault, fault_point
from tpushare_torch.k8s.client import KubeClient
from tpushare_torch.k8s.kubelet import KubeletClient
from tpushare_torch.plugin import const
from tpushare_torch.plugin.backend import Backend, auto_backend
from tpushare_torch.plugin.coredump import coredump
from tpushare_torch.plugin.server import TpuDevicePlugin, new_tpu_device_plugin
from tpushare_torch.plugin.watchers import FSWatcher, OSWatcher

log = logging.getLogger("tpushare.manager")

COREDUMP_DIR = "/etc/kubernetes"

#: re-registration backoff bounds (kubelet restarts race the socket)
REGISTER_BACKOFF_S = 0.2
REGISTER_BACKOFF_MAX_S = 30.0


class _NullSignalSource:
    def get(self, timeout=None):
        if timeout:
            time.sleep(timeout)
        return None


class SharedTpuManager:
    """Reference: sharedGPUManager (gpumanager.go:16-31)."""

    def __init__(self, kube: KubeClient, node_name: str,
                 backend: Optional[Backend] = None,
                 kubelet: Optional[KubeletClient] = None,
                 memory_unit: str = const.GIB,
                 health_check: bool = False,
                 query_kubelet: bool = False,
                 device_plugin_path: str = dp.DEVICE_PLUGIN_PATH,
                 discovery_poll: float = 30.0,
                 coredump_dir: str = COREDUMP_DIR,
                 device_nodes: bool = True):
        self.device_nodes = device_nodes
        self.kube = kube
        self.node_name = node_name
        self.backend = backend
        self.kubelet = kubelet
        self.memory_unit = memory_unit
        self.health_check = health_check
        self.query_kubelet = query_kubelet
        self.device_plugin_path = device_plugin_path
        self.discovery_poll = discovery_poll
        self.coredump_dir = coredump_dir
        self.plugin: Optional[TpuDevicePlugin] = None

    def _wait_for_devices(self) -> Backend:
        """Reference hangs forever without a device (gpumanager.go:36-47);
        we poll so the daemon converges once hardware appears."""
        while True:
            try:
                be = self.backend or auto_backend()
                topo = be.probe()
                if topo.chip_count > 0:
                    log.info("discovered %d %s chip(s), mesh %s via %s",
                             topo.chip_count, topo.generation, topo.mesh, be.name)
                    return be
            except Exception as e:
                log.info("no TPU devices found (%s); waiting. Is this a "
                         "TPU node?", e)
            time.sleep(self.discovery_poll)

    def _build_and_serve(self) -> TpuDevicePlugin:
        plugin = new_tpu_device_plugin(
            self.backend, self.kube, self.node_name,
            memory_unit=self.memory_unit, kubelet=self.kubelet,
            query_kubelet=self.query_kubelet,
            health_check=self.health_check,
            device_plugin_path=self.device_plugin_path,
            device_nodes=self.device_nodes)
        plugin.serve()
        return plugin

    def run(self, max_iterations: Optional[int] = None) -> None:
        """The restart loop (gpumanager.go:33-111). ``max_iterations``
        bounds the loop for tests; None = run until INT/TERM."""
        self.backend = self._wait_for_devices()

        log.info("starting FS watcher on %s", self.device_plugin_path)
        watcher = FSWatcher(self.device_plugin_path)
        log.info("starting OS watcher")
        if threading.current_thread() is threading.main_thread():
            sigs = OSWatcher(signal.SIGHUP, signal.SIGINT, signal.SIGTERM,
                             signal.SIGQUIT)
        else:  # signal handlers are main-thread-only (test harnesses)
            sigs = _NullSignalSource()

        kubelet_sock = os.path.join(self.device_plugin_path, "kubelet.sock")
        fault_kubelet = fault_point("plugin.kubelet_restart")
        restart = True
        ever_served = False
        backoff = 0.0
        iterations = 0
        try:
            while True:
                if restart:
                    if self.plugin is not None:
                        self.plugin.stop()
                        self.plugin = None
                    try:
                        self.plugin = self._build_and_serve()
                    except Exception as e:
                        if not ever_served:
                            # First boot: a bad config must crash
                            # loudly, never retry itself forever.
                            log.error("failed to start device plugin: "
                                      "%s", e)
                            raise
                        # Re-registration after a kubelet restart
                        # races the new kubelet's Registration
                        # service: retry with exponential backoff
                        # instead of orphaning the plugin (the
                        # scheduling plane's process-death gap).
                        backoff = min(REGISTER_BACKOFF_MAX_S,
                                      (backoff * 2) or REGISTER_BACKOFF_S)
                        log.warning("re-register failed (%s); "
                                    "retrying in %.1fs", e, backoff)
                        iterations += 1
                        if (max_iterations is not None
                                and iterations >= max_iterations):
                            return
                        time.sleep(backoff)
                        continue
                    restart = False
                    ever_served = True
                    backoff = 0.0

                iterations += 1
                if max_iterations is not None and iterations >= max_iterations:
                    return

                # Chaos: an injected kubelet restart — the
                # same restart path as the real inotify signal, so the
                # re-register-with-backoff machinery is exercisable
                # without a real kubelet dying.
                try:
                    fault_kubelet()
                except InjectedFault:
                    log.info("chaos: injected kubelet restart")
                    restart = True
                    continue

                # one select round: fs events + signals
                try:
                    ev = watcher.events.get(timeout=0.2)
                    if ev.name == kubelet_sock and ev.is_create:
                        log.info("inotify: %s created, restarting", kubelet_sock)
                        restart = True
                    continue
                except queue.Empty:
                    pass
                s = sigs.get(timeout=0.2)
                if s is None:
                    continue
                if s == signal.SIGHUP:
                    log.info("received SIGHUP, restarting")
                    restart = True
                elif s == signal.SIGQUIT:
                    ts = time.strftime("%Y%m%d%H%M%S")
                    path = os.path.join(self.coredump_dir, f"tpushare_{ts}.txt")
                    log.info("generating stack dump at %s", path)
                    try:
                        coredump(path)
                    except OSError as e:
                        log.warning("stack dump failed: %s", e)
                else:
                    log.info("received signal %s, shutting down", s)
                    return
        finally:
            if self.plugin is not None:
                self.plugin.stop()
            watcher.close()
