"""BASELINE.md's first row, the ``demo/binpack-1`` dry-run, over the port's
control plane, with BASELINE's whole-card Gemma-2B pod served by two
tenants the plugin placed. The port's counterpart of
``demo/e2e_dryrun.py`` and of ``tests/test_daemon_e2e.py``'s
``test_binpack_manifest_e2e_real_daemon_and_extender``. Run from the
repository root:

    python -m tpushare_torch.tools.binpack                  # on the card
    python -m tpushare_torch.tools.binpack --device cpu

Without ``--device cpu`` it needs a CUDA card and exits 2, naming it,
where there is none. Every piece is a real process or socket on this
host: an HTTP apiserver stub (node GET/PATCH, pod list/GET/PATCH, the
Binding subresource), a kubelet simulator (``Registration`` on
``<dir>/kubelet.sock``; after ``ListAndWatch`` it publishes the device
count as the node's tpu-mem capacity and allocatable), the daemon
(``python -m tpushare_torch.plugin.daemon``), the extender
(``python -m tpushare_torch.extender``) and each pod's container command
run as a process under the envs ``Allocate`` injected. Prints one JSON
line per part, then the record; exits 1 when a gate fails.

- A. The daemon with ``--health-check`` and ``--metrics-port``: on the
  card NVML discovers it (no fake env reaches the daemon); ``--device
  cpu`` runs it on ``--backend fake`` with one fake card of 79.6 GiB.
  It registers; ``ListAndWatch`` lists floor(total / GiB) devices, all
  Healthy; the node carries its tpu-count and topology annotation;
  ``/healthz`` and ``/metrics`` answer.
- B. Five pending pods through ``/tpushare/filter``, ``/tpushare/bind``
  and then ``Allocate`` over gRPC: ``demo/binpack-1``'s 3 x 2 GiB, read
  from the manifest, and two 16 GiB serving pods. All land on the one
  card, each env names it with its grant as the HBM limit, the device
  specs name the card's nodes, every pod is ASSIGNED, and the port's
  ``inspect`` reads 38 of 79 GiB allocated.
- C. The tenants. The binpack pods run the manifest's own command, with
  ``tpushare.utils`` read as ``tpushare_torch.utils`` and the card's
  selector (``NVIDIA_VISIBLE_DEVICES``) printed where the TPU pod prints
  ``TPU_VISIBLE_CHIPS``. The serving pods call ``apply_tenant_limits()``
  before any CUDA use and run the port's engine (``tpushare_torch.cli.
  serve --preset gemma_2b --seed 0``; ``--device cpu``: ``--preset
  tiny``), each answering four greedy completions of chip_smoke.py's
  seeded slice prompts (16, 511, 1024 and 2048 tokens, 32 tokens each)
  one at a time over HTTP. Gates: the two tenants' streams equal, peak
  ``memory_reserved`` within the grant, no ``OutOfMemoryError``, every
  process exits 0.
- D. Health churn: the daemon's ``TPUSHARE_HEALTH_ERRFILES`` names one
  counter file per card and ``TPUSHARE_DRAIN_URL`` tenant 0's
  ``/drain``. A control window of two polls with no bump must show no
  transition. Then the counter is bumped: within two polls every device
  must read Unhealthy, tenant 0 must refuse a completion (503) while its
  ``/healthz`` stays 200 (the plugin's ``/mesh/chip`` push); after the
  monitor's quiet polls every device reads Healthy again, the
  ``/undrain`` push lands and the 16-token prompt (one block: never a
  prefix hit) is served again, equal to its completion before the churn.
- E. The health sources the daemon logged at startup (AER, NVML's XID
  events: registered, or the NVML error) and any XID it saw.

On the card the daemon polls health every 5 s, its own default. With
``--device cpu`` the tool sets a 0.5 s poll inside the daemon process
(the daemon has no flag for it), so that the churn takes seconds.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import textwrap
import threading
import time
from concurrent import futures
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
MANIFEST = os.path.join(REPO, "demo", "binpack-1", "binpack-1.yaml")
NODE = "node-1"
NAMESPACE = "default"
RESULT_TAG = "BINPACK_TENANT "
SERVE_UNITS = 16
SERVE_PODS = 2
#: chip_smoke.py's slice prompts: default_rng(0) draws these lengths over
#: the model's vocabulary, in this order.
SLICE_LENGTHS = (16, 100, 255, 511, 700, 1024, 1500, 2048)
#: The four the serving tenants answer: 16, 511, 1024 and 2048 tokens.
SERVE_PROMPTS = (0, 3, 5, 7)
MAX_TOKENS = 32
#: The churn's before/after prompt: 16 tokens, one block, which the
#: prefix cache never serves whole, so both admissions compute alike.
CHURN_PROMPT = 0
DAEMON_HEALTH_INTERVAL_S = 5.0      # TpuDevicePlugin's default poll
CPU_HEALTH_INTERVAL_S = 0.5         # the poll of a --device cpu run
RECOVERY_POLLS = 3                  # ErrorCounterMonitor's default
#: Time the observer may lag a transition it reads off the stream.
OBSERVE_SLACK_S = 1.0
CPU_CARD_GIB = 79.6                 # floor: 79 devices, as an H100 80GB
START_TIMEOUT_S = 120.0
TENANT_TIMEOUT_S = 300.0
REQUEST_TIMEOUT_S = 300.0


# -- the manifest ------------------------------------------------------------

def binpack_pods(path: str = MANIFEST) -> Tuple[int, str, int, str]:
    """(replicas, container name, tpu-mem units, the container's script)
    of the manifest's StatefulSet: its replica count, its first
    container's name and tpu-mem limit, and the last item of that
    container's command, a ``|`` literal. Read without a YAML library,
    which the card machine lacks."""
    from tpushare_torch.plugin import const
    with open(path) as f:
        text = f.read()
    sts = text[text.index("kind: StatefulSet"):]
    replicas = int(re.search(r"^\s+replicas:\s*(\d+)", sts, re.M).group(1))
    name = re.search(r"containers:\s*\n\s*- name:\s*(\S+)", sts).group(1)
    mem = int(re.search(re.escape(const.RESOURCE_NAME) + r":\s*(\d+)",
                        sts).group(1))
    literal = re.search(r"^( *)- \|\n((?:\1 .*\n|[ \t]*\n)*)", sts, re.M)
    return replicas, name, mem, textwrap.dedent(literal.group(2))


def port_script(script: str) -> str:
    """The manifest's container script as the port's pod runs it: the
    port's tenant module, the card's selector env, no sleep."""
    return (script.replace("tpushare.utils", "tpushare_torch.utils")
            .replace("TPU_VISIBLE_CHIPS", "NVIDIA_VISIBLE_DEVICES")
            .replace("time.sleep(3600)", ""))


# -- the apiserver stub ---------------------------------------------------------

class Apiserver(ThreadingHTTPServer):
    """The apiserver surface the daemon, the extender and inspect use:
    node GET/PATCH, pod list (fieldSelector spec.nodeName and
    status.phase)/GET/PATCH, and the v1 Binding subresource."""

    def __init__(self, node_names=(NODE,)):
        self.nodes = {name: {
            "metadata": {"name": name, "labels": {}, "annotations": {}},
            "status": {"capacity": {}, "allocatable": {},
                       "addresses": [{"type": "InternalIP",
                                      "address": "127.0.0.1"}]},
        } for name in node_names}
        self.pods: List[dict] = []
        self.lock = threading.Lock()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *a):
                pass

            def _send(self, obj, code=200):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _body(self):
                n = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(n) or b"{}")

            def _pod(self, path):
                # /api/v1/namespaces/<ns>/pods/<name>[/binding]
                parts = path.strip("/").split("/")
                return outer.pod(parts[3], parts[5])

            def do_GET(self):
                from urllib.parse import parse_qs, urlsplit
                url = urlsplit(self.path)
                path = url.path
                with outer.lock:
                    if path.startswith("/api/v1/nodes/"):
                        node = outer.nodes.get(path.split("/")[4])
                        self._send(node or {}, 200 if node else 404)
                    elif path == "/api/v1/nodes":
                        self._send({"items": list(outer.nodes.values())})
                    elif "/pods/" in path:
                        pod = self._pod(path)
                        self._send(pod or {}, 200 if pod else 404)
                    elif path.endswith("/pods"):
                        sel = dict(kv.split("=", 1) for kv in parse_qs(
                            url.query).get("fieldSelector", [""])[0]
                            .split(",") if "=" in kv)
                        items = [p for p in outer.pods
                                 if _selected(p, sel)]
                        self._send({"items": items})
                    else:
                        self._send({}, 404)

            def do_POST(self):
                path = self.path.split("?")[0]
                body = self._body()
                with outer.lock:
                    pod = self._pod(path) if path.endswith(
                        "/binding") else None
                    if pod is None:
                        self._send({}, 404)
                        return
                    pod["spec"]["nodeName"] = body.get("target", {}).get(
                        "name", "")
                    self._send({}, 201)

            def do_PATCH(self):
                path = self.path.split("?")[0]
                patch = self._body()
                md = patch.get("metadata", {})
                with outer.lock:
                    if path.startswith("/api/v1/nodes/"):
                        node = outer.nodes.get(path.split("/")[4])
                        if node is None:
                            self._send({}, 404)
                            return
                        node["metadata"]["annotations"].update(
                            md.get("annotations") or {})
                        node["metadata"]["labels"].update(
                            md.get("labels") or {})
                        for k in ("capacity", "allocatable"):
                            node["status"][k].update(
                                patch.get("status", {}).get(k) or {})
                        self._send(node)
                    elif "/pods/" in path:
                        pod = self._pod(path)
                        if pod is None:
                            self._send({}, 404)
                            return
                        pod["metadata"].setdefault("annotations", {}).update(
                            md.get("annotations") or {})
                        self._send(pod)
                    else:
                        self._send({}, 404)

        super().__init__(("127.0.0.1", 0), Handler)
        threading.Thread(target=self.serve_forever, daemon=True).start()

    def pod(self, namespace: str, name: str) -> Optional[dict]:
        return next((p for p in self.pods
                     if p["metadata"].get("namespace", NAMESPACE) == namespace
                     and p["metadata"]["name"] == name), None)

    def add_pod(self, name: str, container: str, units: int) -> dict:
        from tpushare_torch.plugin import const
        pod = {"metadata": {"name": name, "namespace": NAMESPACE,
                            "uid": f"uid-{name}", "annotations": {}},
               "spec": {"nodeName": "", "containers": [
                   {"name": container, "resources": {
                       "limits": {const.RESOURCE_NAME: units}}}]},
               "status": {"phase": "Pending"}}
        with self.lock:
            self.pods.append(pod)
        return pod

    def close(self) -> None:
        self.shutdown()
        self.server_close()


def _selected(pod: dict, sel: Dict[str, str]) -> bool:
    if "spec.nodeName" in sel and \
            pod["spec"].get("nodeName", "") != sel["spec.nodeName"]:
        return False
    return not ("status.phase" in sel and pod.get("status", {}).get(
        "phase") != sel["status.phase"])


def write_kubeconfig(path: str, api_port: int) -> str:
    with open(path, "w") as f:
        json.dump({
            "current-context": "t",
            "contexts": [{"name": "t",
                          "context": {"cluster": "c", "user": "u"}}],
            "clusters": [{"name": "c", "cluster": {
                "server": f"http://127.0.0.1:{api_port}"}}],
            "users": [{"name": "u", "user": {}}],
        }, f)
    return path


# -- the kubelet simulator ------------------------------------------------------

class KubeletSim:
    """``Registration`` on ``<dpp>/kubelet.sock``; then a kubelet's view of
    the plugin: one ``ListAndWatch`` stream read by a thread (every
    response kept with its time), the device count published as node
    capacity, ``Allocate`` calls."""

    def __init__(self, dpp: str, api: Apiserver):
        import grpc
        from tpushare_torch import deviceplugin as dp
        from tpushare_torch.deviceplugin import pb
        self.dpp, self.api = dpp, api
        self.registrations: List[Tuple[float, object]] = []
        self.updates: List[Tuple[float, List[str]]] = []
        self.devices: List[str] = []
        self._changed = threading.Condition()
        sim = self

        class Registration(dp.RegistrationServicer):
            def Register(self, request, context):
                with sim._changed:
                    sim.registrations.append((time.monotonic(), request))
                    sim._changed.notify_all()
                return pb.Empty()

        self._server = grpc.server(futures.ThreadPoolExecutor(max_workers=2))
        dp.add_RegistrationServicer_to_server(Registration(), self._server)
        self._server.add_insecure_port(f"unix:{dpp}/kubelet.sock")
        self._server.start()
        self._channel = None
        self._stream = None

    def wait(self, pred, timeout: float, what: str):
        deadline = time.monotonic() + timeout
        with self._changed:
            while not pred():
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"kubelet sim: {what} not seen in "
                                       f"{timeout} s")
                self._changed.wait(min(left, 0.5))

    def watch(self, timeout: float = START_TIMEOUT_S) -> List[str]:
        """Open ListAndWatch; the first list's IDs, once the node
        advertises their count (the kubelet's duty)."""
        import grpc
        from tpushare_torch import deviceplugin as dp
        from tpushare_torch.deviceplugin import pb
        from tpushare_torch.plugin import const
        self._channel = grpc.insecure_channel(
            f"unix:{self.dpp}/{const.SERVER_SOCK_NAME}")
        self.stub = dp.DevicePluginStub(self._channel)
        self._stream = self.stub.ListAndWatch(pb.Empty())

        def read():
            try:
                for resp in self._stream:
                    with self._changed:
                        if not self.devices:
                            self.devices = [d.ID for d in resp.devices]
                        self.updates.append(
                            (time.monotonic(),
                             [d.health for d in resp.devices]))
                        self._changed.notify_all()
            except grpc.RpcError:
                pass

        threading.Thread(target=read, daemon=True).start()
        self.wait(lambda: self.updates, timeout, "a device list")
        with self.api.lock:
            for key in ("capacity", "allocatable"):
                self.api.nodes[NODE]["status"][key][const.RESOURCE_NAME] = \
                    len(self.devices)
        return self.devices

    def allocate(self, ids: List[str]):
        """(the container's response, seconds) of one pod's Allocate."""
        from tpushare_torch.deviceplugin import pb
        t0 = time.perf_counter()
        resp = self.stub.Allocate(pb.AllocateRequest(container_requests=[
            pb.ContainerAllocateRequest(devicesIDs=ids)]))
        return resp.container_responses[0], time.perf_counter() - t0

    def close(self) -> None:
        if self._stream is not None:
            self._stream.cancel()
        if self._channel is not None:
            self._channel.close()
        self._server.stop(grace=0).wait()


# -- processes -------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env(extra: Optional[dict] = None, drop=()) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    env.update(extra or {})
    return env


def spawn(cmd: List[str], env: dict, log_path: str) -> subprocess.Popen:
    out = open(log_path, "w")
    try:
        return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=out,
                                stderr=subprocess.STDOUT, text=True)
    finally:
        out.close()


def stop(proc: subprocess.Popen, timeout: float = 30.0) -> Optional[int]:
    """SIGTERM, then SIGKILL past ``timeout``; the exit code (None when
    it had to be killed)."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout)
            return None
    return proc.returncode


def http_call(port: int, method: str, path: str, body=None,
              timeout: float = 10.0) -> Tuple[int, bytes]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path,
                     None if body is None else json.dumps(body).encode(),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def wait_http(port: int, path: str, proc: subprocess.Popen, timeout: float,
              log_path: str) -> float:
    """Seconds until ``path`` answers 200; raises if ``proc`` exits."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if proc.poll() is not None:
            raise RuntimeError(f"exited rc={proc.returncode} before "
                               f"{path} answered: {tail(log_path)}")
        try:
            if http_call(port, "GET", path, timeout=2.0)[0] == 200:
                return time.monotonic() - t0
        except OSError:
            pass
        time.sleep(0.1)
    raise TimeoutError(f":{port}{path} not 200 in {timeout} s")


def tail(path: str, n: int = 1200) -> str:
    try:
        with open(path) as f:
            return f.read()[-n:]
    except OSError:
        return ""


def complete(port: int, prompt: List[int], max_tokens: int = MAX_TOKENS):
    """One greedy completion, streamed: {status, tokens, ttft_ms,
    ms_per_token (the gaps between token frames: one decode tick
    each)}."""
    conn = http.client.HTTPConnection("127.0.0.1", port,
                                      timeout=REQUEST_TIMEOUT_S)
    try:
        t0 = time.perf_counter()
        conn.request("POST", "/v1/completions", json.dumps(
            {"prompt": prompt, "max_tokens": max_tokens,
             "stream": True}).encode(),
            {"Content-Type": "application/json"})
        resp = conn.getresponse()
        if resp.status != 200:
            return {"status": resp.status,
                    "body": resp.read().decode(errors="replace")[:200]}
        tokens, times, error = [], [], None
        for line in resp:
            if not line.startswith(b"data: "):
                continue
            ev = json.loads(line[len(b"data: "):])
            if "token" in ev:
                tokens.append(ev["token"])
                times.append(time.perf_counter())
            if "error" in ev:
                error = ev["error"]
            if "done" in ev or "error" in ev:
                break
    finally:
        conn.close()
    gaps = [b - a for a, b in zip(times, times[1:])]
    return {"status": 200, "tokens": tokens, "error": error,
            "ttft_ms": (times[0] - t0) * 1e3 if times else None,
            "ms_per_token": (sum(gaps) / len(gaps) * 1e3) if gaps else None}


# -- the run ------------------------------------------------------------------------

def node_topology(device: str):
    """The node as the daemon will discover it: NVML's cards, or the CPU
    run's one fake card."""
    if device == "cpu":
        from tpushare_torch.plugin.backend import FakeBackend
        return FakeBackend(chips=1, hbm_gib=CPU_CARD_GIB).probe()
    from tpushare_torch.plugin.nvmldisc import NvmlBackend
    return NvmlBackend().probe()


def slice_prompts(device: str) -> List[List[int]]:
    import numpy as np
    from tpushare_torch.models import transformer as tt
    vocab = (tt.tiny() if device == "cpu" else tt.gemma_2b()).vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, n) for n in SLICE_LENGTHS]
    return [prompts[i].tolist() for i in SERVE_PROMPTS]


def serve_argv(device: str, port: int) -> List[str]:
    if device == "cpu":
        return ["--preset", "tiny", "--device", "cpu", "--seed", "0",
                "--port", str(port)]
    return ["--preset", "gemma_2b", "--seed", "0", "--n-slots", "8",
            "--n-blocks", "1024", "--block-size", "16", "--port", str(port)]


class Run:
    """One dry-run: its scratch dir, processes and the record's parts."""

    def __init__(self, args, log):
        self.args, self.log = args, log
        self.interval = (CPU_HEALTH_INTERVAL_S if args.device == "cpu"
                         else DAEMON_HEALTH_INTERVAL_S)
        self.tmp = tempfile.mkdtemp(prefix="bp-")
        self.failures: List[str] = []
        self.record: Dict[str, object] = {"device": args.device}
        self.procs: List[subprocess.Popen] = []
        self.api: Optional[Apiserver] = None
        self.kubelet: Optional[KubeletSim] = None

    def fail(self, part: str, what: str) -> None:
        self.failures.append(f"{part}: {what}")

    def emit(self, part: str, obj: dict) -> None:
        self.record[part] = obj
        self.log(json.dumps({"part": part, **obj}))

    def path(self, name: str) -> str:
        return os.path.join(self.tmp, name)

    # -- A --------------------------------------------------------------
    def start_daemon(self, topo) -> None:
        from tpushare_torch.plugin import const
        self.dpp = self.path("dpp")
        os.makedirs(self.dpp)
        self.api = Apiserver()
        kubeconfig = write_kubeconfig(self.path("kubeconfig"),
                                      self.api.server_address[1])
        self.kubeconfig = kubeconfig
        self.kubelet = KubeletSim(self.dpp, self.api)
        os.makedirs(self.path("errors"))
        self.counters = {c.index: self.path(f"errors/card{c.index}")
                         for c in topo.chips}
        for p in self.counters.values():
            with open(p, "w") as f:
                f.write("0\n")
        self.metrics_port = free_port()
        self.tenant_ports = [free_port() for _ in range(SERVE_PODS)]
        env = {"NODE_NAME": NODE, "KUBECONFIG": kubeconfig,
               "TPUSHARE_HEALTH_ERRFILES": self.path("errors/card{index}"),
               "TPUSHARE_DRAIN_URL":
                   f"http://127.0.0.1:{self.tenant_ports[0]}/drain"}
        argv = ["--device-plugin-path", self.dpp, "--token", "dummy",
                "--health-check", "--metrics-port", str(self.metrics_port)]
        cmd = ["-m", "tpushare_torch.plugin.daemon", *argv]
        if self.args.device == "cpu":
            env.update(TPUSHARE_FAKE_CHIPS="1",
                       TPUSHARE_FAKE_HBM_GIB=str(CPU_CARD_GIB))
            cmd = ["-m", "tpushare_torch.tools.binpack", "--daemon", "--",
                   *argv, "--backend", "fake"]
        self.daemon_log = self.path("daemon.log")
        t0 = time.monotonic()
        self.daemon = spawn([sys.executable, *cmd], child_env(
            env, drop=("TPUSHARE_FAKE_CHIPS", "TPUSHARE_BACKEND")),
            self.daemon_log)
        self.procs.append(self.daemon)
        try:
            self.kubelet.wait(lambda: self.kubelet.registrations
                              or self.daemon.poll() is not None,
                              START_TIMEOUT_S, "Register")
        except TimeoutError as e:
            raise RuntimeError(f"{e}: {tail(self.daemon_log)}")
        if not self.kubelet.registrations:
            raise RuntimeError(f"daemon exited rc={self.daemon.returncode}"
                               f": {tail(self.daemon_log)}")
        register_s = self.kubelet.registrations[0][0] - t0
        reg = self.kubelet.registrations[0][1]
        devices = self.kubelet.watch()
        units = {c.index: c.hbm_bytes >> 30 for c in topo.chips}
        want = sum(units.values())
        health = self.kubelet.updates[0][1]
        if reg.resource_name != const.RESOURCE_NAME:
            self.fail("A", f"registered {reg.resource_name}")
        if len(devices) != want or set(health) != {"Healthy"}:
            self.fail("A", f"ListAndWatch: {len(devices)} devices "
                           f"({sorted(set(health))}), want {want} Healthy")
        node = self.api.nodes[NODE]
        count = node["status"]["capacity"].get(const.RESOURCE_COUNT)
        annotated = node["metadata"]["annotations"].get(
            const.ANN_NODE_TOPOLOGY)
        if str(count) != str(len(topo.chips)) or not annotated:
            self.fail("A", f"node tpu-count {count}, topology "
                           f"annotation {annotated!r}")
        healthz_s = wait_http(self.metrics_port, "/healthz", self.daemon,
                              START_TIMEOUT_S, self.daemon_log)
        _, metrics = http_call(self.metrics_port, "GET", "/metrics")
        metrics = metrics.decode()
        if f"tpushare_mem_units_advertised {want}" not in metrics:
            self.fail("A", "/metrics does not advertise "
                           f"{want} units")
        self.emit("A", {
            "register_s": register_s, "healthz_after_register_s": healthz_s,
            "resource": reg.resource_name, "devices": len(devices),
            "healthy": health.count("Healthy"), "units_per_card": units,
            "node_tpu_count": count, "topology_annotation": annotated,
            "metrics_has_units": f"tpushare_mem_units_advertised {want}"
                                 in metrics,
            "card": {"index": topo.chips[0].index,
                     "uuid": topo.chips[0].uuid,
                     "device_path": topo.chips[0].device_path}})

    # -- B --------------------------------------------------------------
    def place(self, topo) -> Dict[str, dict]:
        from tpushare_torch.cli import inspect as cli_inspect
        from tpushare_torch.k8s.client import KubeClient, load_config
        from tpushare_torch.plugin import const
        replicas, container, mem, self.script = binpack_pods()
        pods = [(f"binpack-1-{i}", container, mem) for i in range(replicas)]
        pods += [(f"gemma-2b-{i}", "gemma-2b", SERVE_UNITS)
                 for i in range(SERVE_PODS)]
        for name, cont, units in pods:
            self.api.add_pod(name, cont, units)
        ext_port = free_port()
        self.ext_log = self.path("extender.log")
        self.extender = spawn(
            [sys.executable, "-m", "tpushare_torch.extender", "--host",
             "127.0.0.1", "--port", str(ext_port), "--kubeconfig",
             self.kubeconfig], child_env(), self.ext_log)
        self.procs.append(self.extender)
        deadline = time.monotonic() + START_TIMEOUT_S
        while True:
            try:
                socket.create_connection(("127.0.0.1", ext_port), 1).close()
                break
            except OSError:
                if self.extender.poll() is not None or \
                        time.monotonic() > deadline:
                    raise RuntimeError(f"extender not serving: "
                                       f"{tail(self.ext_log)}")
                time.sleep(0.1)

        def post(verb, body):
            st, out = http_call(ext_port, "POST", f"/tpushare/{verb}", body,
                                timeout=30)
            return json.loads(out) if st == 200 else {"Error": st}

        sched = {}
        for name, _, units in pods:
            t0 = time.perf_counter()
            with self.api.lock:
                obj = json.loads(json.dumps(self.api.pod(NAMESPACE, name)))
            filt = post("filter", {"Pod": obj, "NodeNames": [NODE]})
            t1 = time.perf_counter()
            bind = post("bind", {"PodNamespace": NAMESPACE, "PodName": name,
                                 "Node": NODE})
            t2 = time.perf_counter()
            sched[name] = {"filter_ms": (t1 - t0) * 1e3,
                           "bind_ms": (t2 - t1) * 1e3}
            if filt.get("NodeNames") != [NODE] or bind.get("Error") != "":
                self.fail("B", f"{name}: filter {filt}, bind {bind}")
        ids = iter(self.kubelet.devices)
        grants = {}
        for name, _, units in pods:
            resp, secs = self.kubelet.allocate(
                [next(ids) for _ in range(units)])
            grants[name] = {"units": units, "envs": dict(resp.envs),
                            "devices": [d.host_path for d in resp.devices],
                            "allocate_ms": secs * 1e3}
        card = topo.chips[0]
        nodes = [card.device_path, *topo.shared_device_paths]
        placed = set()
        for name, g in grants.items():
            envs = g["envs"]
            with self.api.lock:
                ann = dict(self.api.pod(NAMESPACE, name)["metadata"][
                    "annotations"])
            placed.add(ann.get(const.ANN_RESOURCE_INDEX))
            want = {const.ENV_NVIDIA_VISIBLE_DEVICES: str(card.index),
                    const.ENV_RESOURCE_INDEX: str(card.index),
                    const.ENV_HBM_LIMIT_BYTES: str(g["units"] << 30)}
            bad = {k: envs.get(k) for k, v in want.items()
                   if envs.get(k) != v}
            if bad or g["devices"] != nodes:
                self.fail("B", f"{name}: envs {bad}, devices "
                               f"{g['devices']} (want {nodes})")
            if ann.get(const.ANN_ASSIGNED_FLAG) != "true":
                self.fail("B", f"{name}: not ASSIGNED ({ann})")
            g["annotations"] = ann
        if placed != {str(card.index)}:
            self.fail("B", f"placed on {placed}, not the one card")
        out = io.StringIO()
        rc = cli_inspect.main([], kube=KubeClient(load_config(
            self.kubeconfig)), out=out)
        summary = out.getvalue()
        total = sum(g["units"] for g in grants.values())
        cap = len(self.kubelet.devices)
        m = re.search(r"In Cluster:\n(\d+)/(\d+)", summary)
        got = (int(m.group(1)), int(m.group(2))) if m else None
        if rc != 0 or got != (total, cap):
            self.fail("B", f"inspect rc={rc} read {got}, want "
                           f"{(total, cap)}:\n{summary}")
        self.emit("B", {"pods": [n for n, _, _ in pods],
                        "schedule": sched, "grants": grants,
                        "inspect": summary, "allocated_of": got})
        return grants

    # -- C --------------------------------------------------------------
    def run_binpack_tenants(self, grants: Dict[str, dict]) -> None:
        from tpushare_torch.plugin import const
        script = port_script(self.script)
        procs = {}
        for name, g in grants.items():
            if not name.startswith("binpack-1-"):
                continue
            procs[name] = subprocess.Popen(
                [sys.executable, "-c", script], env=child_env(g["envs"]),
                cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)
            self.procs.append(procs[name])
        out = {}
        for name, p in procs.items():
            try:
                text, _ = p.communicate(timeout=START_TIMEOUT_S)
            except subprocess.TimeoutExpired:
                p.kill()
                text, _ = p.communicate()
            envs = grants[name]["envs"]
            want = [f"NVIDIA_VISIBLE_DEVICES: "
                    f"{envs[const.ENV_NVIDIA_VISIBLE_DEVICES]}",
                    f"HBM limit: {envs[const.ENV_HBM_LIMIT_BYTES]}"]
            out[name] = {"rc": p.returncode, "stdout": text[-400:]}
            if p.returncode != 0 or not all(w in text for w in want):
                self.fail("C", f"{name} rc={p.returncode}: {text[-400:]!r}")
        self.binpack_out = out

    def start_serve_tenants(self, grants: Dict[str, dict]) -> None:
        self.tenants = []
        for i in range(SERVE_PODS):
            log_path = self.path(f"gemma-2b-{i}.log")
            cmd = [sys.executable, "-m", "tpushare_torch.tools.binpack",
                   "--serve-tenant", "--",
                   *serve_argv(self.args.device, self.tenant_ports[i])]
            p = spawn(cmd, child_env(grants[f"gemma-2b-{i}"]["envs"]),
                      log_path)
            self.procs.append(p)
            self.tenants.append((p, self.tenant_ports[i], log_path))
        self.tenant_ready_s = [
            wait_http(port, "/healthz", p, TENANT_TIMEOUT_S, log_path)
            for p, port, log_path in self.tenants]

    def serve_requests(self, prompts) -> List[List[dict]]:
        results: List[List[dict]] = [[] for _ in self.tenants]

        def client(i, port):
            for prompt in prompts:
                results[i].append(complete(port, prompt))

        threads = [threading.Thread(target=client, args=(i, port))
                   for i, (_, port, _) in enumerate(self.tenants)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(REQUEST_TIMEOUT_S * len(prompts))
        return results

    # -- D --------------------------------------------------------------
    def health_window(self, since: float) -> List[Tuple[float, List[str]]]:
        with self.kubelet._changed:
            return [u for u in self.kubelet.updates if u[0] > since]

    def churn(self, prompts, before: dict) -> None:
        port = self.tenants[0][1]
        poll = self.interval
        record = {"interval_s": poll, "recovery_polls": RECOVERY_POLLS}
        # Control: two polls with no bump must show no transition.
        t0 = time.monotonic()
        time.sleep(2 * poll + OBSERVE_SLACK_S)
        quiet = self.health_window(t0)
        record["control_transitions"] = len(quiet)
        if quiet:
            self.fail("D", f"control window saw {len(quiet)} transitions")
        path = self.counters[min(self.counters)]
        with open(path, "w") as f:
            f.write("1\n")
        t_bump = time.monotonic()
        try:
            self.kubelet.wait(lambda: any(
                u[0] > t_bump and set(u[1]) == {"Unhealthy"}
                for u in self.kubelet.updates),
                2 * poll + OBSERVE_SLACK_S, "every device Unhealthy")
        except TimeoutError as e:
            self.fail("D", str(e))
            self.emit("D", record)
            return
        down = next(u for u in self.kubelet.updates
                    if u[0] > t_bump and set(u[1]) == {"Unhealthy"})
        record["detect_s"] = down[0] - t_bump
        record["unhealthy_devices"] = len(down[1])
        # The /mesh/chip push follows the transition: a new completion
        # must be refused while /healthz stays 200.
        refused, deadline = None, time.monotonic() + 10 * poll
        while time.monotonic() < deadline:
            refused = http_call(port, "POST", "/v1/completions", {
                "prompt": prompts[CHURN_PROMPT], "max_tokens": 4},
                timeout=REQUEST_TIMEOUT_S)[0]
            if refused == 503:
                break
            time.sleep(0.1)
        healthz = http_call(port, "GET", "/healthz")[0]
        record["refused_status"], record["healthz_while_drained"] = \
            refused, healthz
        if refused != 503 or healthz != 200:
            self.fail("D", f"drained tenant answered {refused}, /healthz "
                           f"{healthz}")
        try:
            self.kubelet.wait(lambda: any(
                u[0] > down[0] and set(u[1]) == {"Healthy"}
                for u in self.kubelet.updates),
                (RECOVERY_POLLS + 2) * poll + OBSERVE_SLACK_S,
                "every device Healthy again")
        except TimeoutError as e:
            self.fail("D", str(e))
            self.emit("D", record)
            return
        up = next(u for u in self.kubelet.updates
                  if u[0] > down[0] and set(u[1]) == {"Healthy"})
        record["recover_s"] = up[0] - down[0]
        # The /undrain push: served again, equal to before the churn.
        again, deadline = None, time.monotonic() + 10 * poll
        while time.monotonic() < deadline:
            again = complete(port, prompts[CHURN_PROMPT])
            if again["status"] == 200 and again["error"] is None:
                break
            time.sleep(0.1)
        record["served_again"] = again["status"]
        record["equal_to_before"] = again.get("tokens") == before["tokens"]
        if again["status"] != 200 or again["error"] is not None \
                or not record["equal_to_before"]:
            self.fail("D", f"after recovery: {again} vs {before['tokens']}")
        record["transitions"] = [
            (round(t - t_bump, 3), sorted(set(h)))
            for t, h in self.health_window(t_bump)]
        self.emit("D", record)

    # -- the whole ------------------------------------------------------
    def run(self) -> dict:
        t_run = time.monotonic()
        try:
            topo = node_topology(self.args.device)
            self.start_daemon(topo)
            grants = self.place(topo)
            self.run_binpack_tenants(grants)
            prompts = slice_prompts(self.args.device)
            self.start_serve_tenants(grants)
            served = self.serve_requests(prompts)
            streams = [[r.get("tokens") for r in rs] for rs in served]
            if any(r.get("status") != 200 or r.get("error") or
                   len(r.get("tokens") or ()) != MAX_TOKENS
                   for rs in served for r in rs) or \
                    any(len(rs) != len(prompts) for rs in served):
                self.fail("C", f"completions: {served}")
            elif any(s != streams[0] for s in streams):
                self.fail("C", "the tenants' streams differ")
            self.churn(prompts, served[0][CHURN_PROMPT])
            tenants = []
            for (p, port, log_path), rs in zip(self.tenants, served):
                rc = stop(p)
                text = tail(log_path, 1 << 20)
                lines = [l for l in text.splitlines()
                         if l.startswith(RESULT_TAG)]
                res = json.loads(lines[-1][len(RESULT_TAG):]) if lines \
                    else {}
                oom = "OutOfMemoryError" in text
                tenants.append({"rc": rc, "oom": oom, **res,
                                "ttft_ms": [r.get("ttft_ms") for r in rs],
                                "ms_per_token": [r.get("ms_per_token")
                                                 for r in rs]})
                peak = res.get("max_memory_reserved")
                if rc != 0 or oom or not res:
                    self.fail("C", f"tenant on :{port} rc={rc} oom={oom}: "
                                   f"{text[-600:]!r}")
                elif peak is not None and peak > res["grant_bytes"]:
                    self.fail("C", f"tenant on :{port} reserved {peak} "
                                   f"past its grant {res['grant_bytes']}")
                if self.args.device == "cuda" and not all(
                        res.get("launches", {}).get(k, 0) > 0
                        for k in ("flash_attention", "paged_flash_decode")):
                    self.fail("C", f"tenant on :{port} launched "
                                   f"{res.get('launches')}: the admission "
                                   f"and decode kernels must run")
            self.emit("C", {"binpack": self.binpack_out,
                            "tenant_ready_s": self.tenant_ready_s,
                            "prompt_lengths": [len(p) for p in prompts],
                            "max_tokens": MAX_TOKENS,
                            "streams_equal": all(s == streams[0]
                                                 for s in streams),
                            "first_tokens": [s[:8] if s else s
                                             for s in streams[0]],
                            "tenants": tenants})
            rc = stop(self.daemon)
            if rc != 0:
                self.fail("A", f"daemon exited rc={rc} on SIGTERM")
            self.report_sources()
        finally:
            self.close()
        self.record["failures"] = self.failures
        self.record["seconds"] = time.monotonic() - t_run
        return self.record

    def report_sources(self) -> None:
        text = tail(self.daemon_log, 1 << 20)
        m = re.search(r"health sources: (.*)", text)
        sources = m.group(1).strip() if m else None
        xid = re.search(r"xid=(.*)$", sources).group(1) if sources else None
        seen = re.findall(r"critical XID (\d+)", text)
        wait_errors = len(re.findall(r"XID event wait failed", text))
        if sources is None:
            self.fail("E", "the daemon logged no health sources")
        defaults = None
        if self.args.device == "cuda":
            # The sources without the churn's counter files: AER by PCI
            # bus id and the XID events, as this process finds them.
            from tpushare_torch.plugin.health import card_monitor
            from tpushare_torch.plugin.nvmldisc import NvmlBackend
            mon = card_monitor(NvmlBackend())
            defaults = mon.describe()
            mon.close()
        self.emit("E", {"health_sources": sources, "xid_source": xid,
                        "default_sources": defaults,
                        "xids_seen": [int(x) for x in seen],
                        "xid_wait_errors": wait_errors,
                        "daemon_exit": self.daemon.returncode})

    def close(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait(30)
        if self.kubelet is not None:
            self.kubelet.close()
        if self.api is not None:
            self.api.close()
        shutil.rmtree(self.tmp, ignore_errors=True)


def run(args, log=print) -> dict:
    return Run(args, log).run()


# -- the processes this tool starts as itself ------------------------------------

def daemon_main(argv: List[str]) -> int:
    """The daemon of a ``--device cpu`` run, its health poll set to
    ``CPU_HEALTH_INTERVAL_S``."""
    from tpushare_torch.plugin import daemon, server

    class Plugin(server.TpuDevicePlugin):
        def __init__(self, *a, **kw):
            kw["health_interval"] = CPU_HEALTH_INTERVAL_S
            super().__init__(*a, **kw)

    server.TpuDevicePlugin = Plugin
    return daemon.main(argv)


def serve_tenant_main(argv: List[str]) -> int:
    """A serving pod's container: the grant first, then the port's
    engine until SIGTERM; then its memory, guard and launch counts."""
    from tpushare_torch.utils.tenant import (apply_tenant_limits,
                                             get_enforcing_guard)
    spec = apply_tenant_limits()               # before any CUDA use
    import importlib
    from tpushare_torch.cli import serve
    fa = importlib.import_module("tpushare_torch.ops.flash_attention")
    sys.argv = ["tpushare-torch-serve", *argv]
    rc = serve.main()
    import torch
    cuda = torch.cuda.is_initialized()
    guard = get_enforcing_guard()
    print(RESULT_TAG + json.dumps({
        "serve_rc": rc, "grant_bytes": spec.hbm_limit_bytes,
        "memory_reserved": torch.cuda.memory_reserved() if cuda else None,
        "max_memory_reserved": (torch.cuda.max_memory_reserved()
                                if cuda else None),
        "max_memory_allocated": (torch.cuda.max_memory_allocated()
                                 if cuda else None),
        "guard_breaches": guard.breaches if guard else None,
        "launches": {"flash_attention": fa.flash_attention.launches,
                     "paged_flash_decode": fa.paged_flash_decode.launches},
        "device": torch.cuda.get_device_name(0) if cuda else "cpu"}),
        flush=True)
    return rc


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--daemon", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--serve-tenant", action="store_true",
                    help=argparse.SUPPRESS)
    ap.add_argument("rest", nargs=argparse.REMAINDER, help=argparse.SUPPRESS)
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    rest = args.rest[1:] if args.rest[:1] == ["--"] else args.rest
    if args.daemon:
        return daemon_main(rest)
    if args.serve_tenant:
        return serve_tenant_main(rest)
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            print("binpack: no CUDA card; run on an NVIDIA GPU or pass "
                  "--device cpu", file=sys.stderr)
            return 2
    record = run(args, log=lambda s: print(s, flush=True))
    print(json.dumps(record), flush=True)
    return 1 if record["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
