"""Informer-style pod cache, list + watch with re-list fallback: the
port's copy of ``tpushare/k8s/watch.py``. One background thread keeps a
local pod store current from the apiserver's watch stream and re-lists
when the stream ends, errors or its resourceVersion expires (410 Gone).
It backs the extender's read-only verbs (``--pod-cache``); /bind keeps
live reads.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Dict, List, Optional

from tpushare_torch.k8s.client import ApiError, KubeClient
from tpushare_torch.k8s.types import Pod

log = logging.getLogger("tpushare.k8s.watch")


class PodCache:
    def __init__(self, kube: KubeClient, *,
                 field_selector: Optional[str] = None,
                 watch_timeout_s: int = 60,
                 error_backoff_s: float = 2.0,
                 sleep=time.sleep):
        self.kube = kube
        self.field_selector = field_selector
        self.watch_timeout_s = watch_timeout_s
        self.error_backoff_s = error_backoff_s
        self._sleep = sleep
        self._store: Dict[str, Pod] = {}
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_sync: float = 0.0
        self.relists = 0                    # observability + tests

    # -- consumer side -----------------------------------------------------
    def list(self) -> List[Pod]:
        """Snapshot of the cached pods. Falls back to a live LIST while
        the first sync hasn't landed (callers never see an empty cache
        just because the watch thread is still starting); a failing
        fallback LIST raises — "apiserver down" must surface as an
        error, never as "zero pods" (an empty answer would make every
        full node look free to /filter)."""
        if not self._synced.is_set():
            return self.kube.list_pods(field_selector=self.field_selector)
        with self._lock:
            return list(self._store.values())

    # -- loop --------------------------------------------------------------
    def _key(self, pod: Pod) -> str:
        return pod.uid or f"{pod.namespace}/{pod.name}"

    def _relist(self) -> str:
        pods, rv = self.kube.list_pods_with_version(
            field_selector=self.field_selector)
        with self._lock:
            self._store = {self._key(p): p for p in pods}
        self.relists += 1
        self.last_sync = time.time()
        self._synced.set()
        return rv

    def _apply(self, etype: str, pod: Pod) -> None:
        with self._lock:
            if etype == "DELETED":
                self._store.pop(self._key(pod), None)
            else:                           # ADDED | MODIFIED
                self._store[self._key(pod)] = pod
        self.last_sync = time.time()

    def run_forever(self) -> None:
        rv = ""
        while not self._stop.is_set():
            try:
                if not rv:
                    rv = self._relist()
                w0 = time.time()
                n_events = 0
                for etype, pod in self.kube.watch_pods(
                        resource_version=rv,
                        field_selector=self.field_selector,
                        timeout_s=self.watch_timeout_s):
                    if self._stop.is_set():
                        return
                    n_events += 1
                    new_rv = (pod.obj.get("metadata") or {}).get(
                        "resourceVersion")
                    if new_rv:
                        rv = str(new_rv)
                    if etype != "BOOKMARK":
                        self._apply(etype, pod)
                # Clean end of window: re-watch from the last rv. Pace
                # degenerate empty windows (a proxy closing streams
                # instantly would otherwise spin a hot LIST/watch loop).
                if not n_events and time.time() - w0 < 1.0:
                    self._sleep(min(1.0, self.error_backoff_s))
            except ApiError as e:
                if e.status_code == 410:    # expired rv: full re-list
                    log.info("watch resourceVersion expired; re-listing")
                else:
                    log.warning("pod watch failed (%s); re-listing "
                                "after backoff", e)
                    self._sleep(self.error_backoff_s)
                rv = ""
            except Exception as e:          # noqa: BLE001 — keep caching
                log.warning("pod watch loop error (%s); re-listing "
                            "after backoff", e)
                self._sleep(self.error_backoff_s)
                rv = ""

    def start(self) -> "PodCache":
        self._thread = threading.Thread(target=self.run_forever,
                                        name="pod-cache", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
