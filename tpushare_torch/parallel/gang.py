"""Gang liaison: host heartbeats over TCP for multi-host serving.
Counterpart of ``tpushare/parallel/gang.py``, copied (the port imports
nothing of the JAX package).

The failure ladder's last rung needs the serving engine to *notice* a
dead host, and a collective gives it no such signal — a lost process
just hangs the next collective (NCCL) or fails it late. So the gang
runs a liaison loop beside the engine: every follower process
heartbeats its rank (plus its local device-fetch counter, which feeds
the per-process fetch telemetry in /stats) to the leader over a plain
TCP socket, and the leader's ``poll()`` classifies ranks as lost when
their heartbeat goes silent past a bounded timeout. Rejoins are the
same transition in reverse.

Deliberately stdlib-only: the liaison must keep running when the mesh
is wedged mid-collective, so it cannot share the runtime's device path — the same isolation argument as the journal
(crash recovery must not depend on the thing that crashed).
Wire format is newline-delimited JSON, one heartbeat per line:

    {"rank": 1, "device_fetches": 421}

The leader never answers; the socket is a one-way drip. Chaos's
``host.loss`` point injects heartbeat-silence here via ``sever()``
(the leader drops the connection and ignores the rank until it
reconnects), which exercises the exact detection path a kernel panic
on a real host would.
"""

from __future__ import annotations

import json
import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

log = logging.getLogger(__name__)

# A follower reconnects with capped exponential backoff: the gang
# contract promises the leader comes back on the same coordinator
# address (the extender re-derives it from rank-0's node), so spinning
# hard would only thrash a booting host.
_BACKOFF_BASE_S = 0.05
_BACKOFF_CAP_S = 2.0
#: seconds of heartbeat silence after which the leader calls a host lost
HEARTBEAT_TIMEOUT_S = 2.0


class GangLeader:
    """Rank-0 side of the liaison: accept heartbeats, classify silence.

    ``poll()`` is the only decision point — it returns the rank
    transitions since the last call as ``{"lost": [...], "rejoined":
    [...]}`` so the engine tick can translate them into
    ``host_event()`` calls. Rank 0 (the leader itself) is always
    considered alive; it does not heartbeat to itself.
    """

    def __init__(self, num_processes: int, port: int = 0,
                 heartbeat_timeout_s: float = HEARTBEAT_TIMEOUT_S,
                 host: str = "127.0.0.1") -> None:
        if num_processes < 2:
            raise ValueError("a gang needs at least 2 processes")
        self.num_processes = int(num_processes)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self._lock = threading.Lock()
        self._last_seen: Dict[int, float] = {}
        self._fetches: Dict[int, int] = {}
        # Ranks poll() has already reported lost; cleared on rejoin.
        self._reported_lost: set = set()
        self._severed: set = set()
        self._closed = False
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, int(port)))
        self._srv.listen(self.num_processes)
        self.port = self._srv.getsockname()[1]
        self._threads: List[threading.Thread] = []
        t = threading.Thread(target=self._accept_loop,
                             name="gang-leader-accept", daemon=True)
        t.start()
        self._threads.append(t)

    # -- accept/read side ------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._closed:
            try:
                conn, _ = self._srv.accept()
            except OSError:
                return  # closed
            t = threading.Thread(target=self._read_loop, args=(conn,),
                                 name="gang-leader-read", daemon=True)
            t.start()
            self._threads.append(t)

    def _read_loop(self, conn: socket.socket) -> None:
        rank = None
        try:
            buf = b""
            conn.settimeout(0.5)
            while not self._closed:
                try:
                    chunk = conn.recv(4096)
                except socket.timeout:
                    continue
                except OSError:
                    break
                if not chunk:
                    break
                buf += chunk
                while b"\n" in buf:
                    line, buf = buf.split(b"\n", 1)
                    try:
                        beat = json.loads(line)
                        rank = int(beat["rank"])
                    except (ValueError, KeyError, TypeError):
                        continue
                    with self._lock:
                        if rank in self._severed:
                            # Chaos holds the rank silent until it
                            # reconnects on a fresh socket.
                            conn.close()
                            return
                        self._last_seen[rank] = time.monotonic()
                        if "device_fetches" in beat:
                            try:
                                self._fetches[rank] = int(
                                    beat["device_fetches"])
                            except (ValueError, TypeError):
                                pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    # -- engine-facing side ----------------------------------------------

    def poll(self) -> Dict[str, List[int]]:
        """Rank transitions since the last poll.

        A rank is lost when its last heartbeat is older than the
        timeout (or it never heartbeat at all after the grace of one
        timeout from liaison start — a gang member that never shows is
        as dead as one that vanished). Rejoined means a previously-
        reported-lost rank heartbeat again.
        """
        now = time.monotonic()
        lost: List[int] = []
        rejoined: List[int] = []
        with self._lock:
            for rank in range(1, self.num_processes):
                seen = self._last_seen.get(rank)
                # A severed rank's beats are being dropped, so its
                # last_seen simply ages out — detection is ALWAYS the
                # timeout path, injected or real.
                alive = (seen is not None
                         and now - seen <= self.heartbeat_timeout_s)
                if alive and rank in self._reported_lost:
                    self._reported_lost.discard(rank)
                    rejoined.append(rank)
                elif not alive and seen is not None \
                        and rank not in self._reported_lost:
                    # Only ranks we have actually seen can be "lost";
                    # a gang that never fully formed is the plugin's
                    # refusal to fix, not the liaison's.
                    self._reported_lost.add(rank)
                    lost.append(rank)
                    # The injected silence has done its job once the
                    # loss is detected: clear it so the follower's
                    # next reconnect lands as a rejoin.
                    self._severed.discard(rank)
        return {"lost": lost, "rejoined": rejoined}

    def seen_ranks(self) -> List[int]:
        """Ranks that have heartbeat at least once — the only ranks
        ``poll()`` can ever classify as lost."""
        with self._lock:
            return sorted(self._last_seen)

    def sever(self, rank: int) -> None:
        """Chaos seam: silence ``rank``'s heartbeats until it
        reconnects — indistinguishable from a host going dark."""
        with self._lock:
            self._severed.add(rank)

    def process_fetches(self) -> Dict[int, int]:
        """Latest per-rank device_fetches counters from heartbeats."""
        with self._lock:
            return dict(self._fetches)

    def close(self) -> None:
        self._closed = True
        try:
            self._srv.close()
        except OSError:
            pass


class GangFollower:
    """Rank>0 side: a daemon thread dripping heartbeats at the leader.

    ``fetches_fn`` (optional) is sampled at each beat so the leader can
    publish per-process fetch counters; it must be cheap and
    exception-safe (a raising sampler is treated as "no counter").
    Reconnects with capped exponential backoff — bounded timeout +
    backoff is the issue's detection contract.
    """

    def __init__(self, coordinator: str, rank: int,
                 interval_s: float = 0.5,
                 fetches_fn: Optional[Callable[[], int]] = None) -> None:
        host, _, port = coordinator.rpartition(":")
        self.host = host or "127.0.0.1"
        self.port = int(port)
        self.rank = int(rank)
        self.interval_s = float(interval_s)
        self._fetches_fn = fetches_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._beat_loop,
                                        name=f"gang-follower-{rank}",
                                        daemon=True)
        self._thread.start()

    def _beat_loop(self) -> None:
        backoff = _BACKOFF_BASE_S
        sock: Optional[socket.socket] = None
        while not self._stop.is_set():
            if sock is None:
                try:
                    sock = socket.create_connection(
                        (self.host, self.port), timeout=1.0)
                    backoff = _BACKOFF_BASE_S
                except OSError:
                    self._stop.wait(backoff)
                    backoff = min(backoff * 2, _BACKOFF_CAP_S)
                    continue
            beat = {"rank": self.rank}
            if self._fetches_fn is not None:
                try:
                    beat["device_fetches"] = int(self._fetches_fn())
                except Exception:
                    pass
            try:
                sock.sendall((json.dumps(beat) + "\n").encode())
            except OSError:
                try:
                    sock.close()
                except OSError:
                    pass
                sock = None
                continue
            self._stop.wait(self.interval_s)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
