"""The port's deploy manifests (deploy/torch/) held against the port's
own code, with no cluster: the counterpart of test_manifests_e2e.py.

1. RBAC: the port's plugin and extender flows (PodManager, the
   Allocator's patch, EventRecorder, assume/bind, the Lease) run through
   tpushare_torch's KubeClient against a recording apiserver simulator;
   every recorded (resource, verb) must be granted by the roles each
   ServiceAccount binds.
2. Wiring: the DaemonSet's mounts equal the NVML backend's defaults, and
   every container's command parses through the port's own parser, with
   probe ports equal to the flags.
3. The GPU contract: no manifest asks for nvidia.com/gpu or starts a
   module of the JAX package; the card pods run under the NVIDIA runtime.
4. demo/binpack-1 placed through the port's extender core.
"""

import json
import os
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest
import yaml

from tests.fakes import make_node, make_pod, now_ns
from tpushare_torch.k8s.client import KubeClient, _Config
from tpushare_torch.k8s.types import Node, Pod
from tpushare_torch.plugin import const

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEPLOY = os.path.join(REPO, "deploy", "torch")
MANIFESTS = ("device-plugin-ds.yaml", "device-plugin-rbac.yaml",
             "extender-deployment.yaml", "serve-deployment.yaml",
             "router-deployment.yaml")


def load_manifests(*names, root=DEPLOY):
    docs = []
    for name in names:
        with open(os.path.join(root, name)) as f:
            docs.extend(d for d in yaml.safe_load_all(f) if d)
    return docs


def containers(doc):
    return doc.get("spec", {}).get("template", {}).get("spec", {}).get(
        "containers", [])


# --------------------------------------------------------------------------
# Recording apiserver simulator
# --------------------------------------------------------------------------

_ITEM = re.compile(
    r"^/api/v1/(?:namespaces/(?P<ns>[^/]+)/)?(?P<res>nodes|pods|events)"
    r"(?:/(?P<name>[^/]+))?(?:/(?P<sub>status|binding))?$")
_LEASE = re.compile(
    r"^/apis/coordination.k8s.io/v1/namespaces/(?P<ns>[^/]+)/leases"
    r"(?:/(?P<name>[^/]+))?$")


def classify(method: str, path: str):
    """HTTP request -> (resource, verb) in RBAC terms."""
    p = path.split("?")[0]
    if _LEASE.match(p):
        return "leases@coordination.k8s.io", {
            "GET": "get", "POST": "create", "PUT": "update",
            "PATCH": "patch"}[method]
    m = _ITEM.match(p)
    assert m, f"unclassifiable apiserver path {path!r}"
    res = m.group("res")
    if m.group("sub") == "binding":
        return "pods/binding", "create"
    if m.group("sub"):
        res = f"{res}/{m.group('sub')}"
    if method == "GET":
        return res, ("get" if m.group("name") else "list")
    return res, {"PATCH": "patch", "PUT": "update",
                 "POST": "create", "DELETE": "delete"}[method]


class _Sim(BaseHTTPRequestHandler):
    """Canned-response apiserver: enough shape for the client code."""

    def log_message(self, *a):
        pass

    def _reply(self, code, obj):
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _handle(self):
        self.server.recorded.append((self.command, self.path))
        n = int(self.headers.get("Content-Length") or 0)
        if n:
            self.rfile.read(n)
        p = self.path.split("?")[0]
        lease = _LEASE.match(p)
        if lease:
            name, leases = lease.group("name"), self.server.leases
            if self.command == "GET":
                if name in leases:
                    self._reply(200, leases[name])
                else:
                    self._reply(404, {"message": "not found",
                                      "reason": "NotFound"})
            elif self.command == "POST":
                obj = {"metadata": {"name": "tpushare-torch-extender",
                                    "resourceVersion": "1"}, "spec": {}}
                leases[obj["metadata"]["name"]] = obj
                self._reply(201, obj)
            else:
                leases[name]["metadata"]["resourceVersion"] = "2"
                self._reply(200, leases[name])
            return
        m = _ITEM.match(p)
        assert m, self.path
        res, name = m.group("res"), m.group("name")
        if res == "events" or m.group("sub") == "binding":
            self._reply(201, {})
        elif res == "nodes":
            self._reply(200, make_node(name or "node-1",
                                       capacity={const.RESOURCE_NAME: 80,
                                                 const.RESOURCE_COUNT: 1}))
        elif name:
            self._reply(200, make_pod(name, mem=2, idx="0",
                                      assume_ns=now_ns()))
        else:
            self._reply(200, {"items": [make_pod("binpack-1-0", mem=2,
                                                 idx="0",
                                                 assume_ns=now_ns())]})

    do_GET = do_POST = do_PATCH = do_PUT = do_DELETE = _handle


@pytest.fixture()
def sim():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _Sim)
    httpd.recorded = []
    httpd.leases = {}
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    kube = KubeClient(_Config(host="127.0.0.1",
                              port=httpd.server_address[1], scheme="http"))
    try:
        yield kube, httpd
    finally:
        httpd.shutdown()
        httpd.server_close()


def role_grants(docs, role_name):
    """{resource-key: set(verbs)} for a (Cluster)Role; group-qualified
    keys for non-core groups."""
    grants = {}
    for d in docs:
        if d.get("kind") not in ("ClusterRole", "Role"):
            continue
        if d["metadata"]["name"] != role_name:
            continue
        for rule in d.get("rules", []):
            for group in rule.get("apiGroups", [""]):
                for res in rule.get("resources", []):
                    key = res if group == "" else f"{res}@{group}"
                    grants.setdefault(key, set()).update(rule["verbs"])
    assert grants, f"role {role_name} not found"
    return grants


def bound_roles(docs, sa_name):
    out = []
    for d in docs:
        if d.get("kind") not in ("ClusterRoleBinding", "RoleBinding"):
            continue
        if any(s.get("kind") == "ServiceAccount" and s.get("name") == sa_name
               for s in d.get("subjects", [])):
            out.append(d["roleRef"]["name"])
    return out


def assert_covered(recorded, grants, context):
    assert recorded, f"{context}: no apiserver call was recorded"
    for method, path in recorded:
        res, verb = classify(method, path)
        assert res in grants and verb in grants[res], (
            f"{context}: code performed '{verb} {res}' "
            f"({method} {path}) but RBAC grants {grants.get(res, set())}")


# --------------------------------------------------------------------------
# 1. RBAC vs the port's flows
# --------------------------------------------------------------------------

class TestRBAC:
    def test_plugin_flows_covered_by_plugin_role(self, sim):
        kube, httpd = sim
        from tpushare_torch.k8s.events import EventRecorder
        from tpushare_torch.plugin.backend import FakeBackend
        from tpushare_torch.plugin.podmanager import PodManager

        mgr = PodManager(kube, "node-1", sleep=lambda s: None)
        mgr.patch_chip_resources(1, 1)
        mgr.publish_topology(FakeBackend(chips=1).probe())
        mgr.disable_isolation_or_not()
        mgr.get_candidate_pods()
        kube.patch_pod("default", "binpack-1-0",
                       {"metadata": {"annotations": {}}})
        EventRecorder(kube, "node-1").pod_event(
            Pod(make_pod("binpack-1-0", mem=2)), "Allocated", "test")

        docs = load_manifests("device-plugin-rbac.yaml")
        roles = bound_roles(docs, "tpushare-torch-device-plugin")
        assert roles == ["tpushare-torch-device-plugin"]
        assert_covered(httpd.recorded, role_grants(docs, roles[0]), "plugin")

    def test_extender_flows_covered_by_extender_role(self, sim):
        kube, httpd = sim
        from tpushare_torch.extender import core
        from tpushare_torch.extender.leader import LeaderElector

        pod = Pod(make_pod("binpack-1-0", mem=2, assigned=None))
        core.assume_pod(kube, pod, "node-1", [0], 2)
        kube.list_nodes()
        kube.list_pods()
        elector = LeaderElector(kube, "pod-a",
                                name="tpushare-torch-extender")
        assert elector.try_acquire_or_renew()
        assert elector.try_acquire_or_renew()

        docs = load_manifests("device-plugin-rbac.yaml")
        roles = bound_roles(docs, "tpushare-torch-extender")
        assert sorted(roles) == ["tpushare-torch-extender",
                                 "tpushare-torch-extender-leases"]
        grants = {}
        for r in roles:
            for k, v in role_grants(docs, r).items():
                grants.setdefault(k, set()).update(v)
        assert_covered(httpd.recorded, grants, "extender")

    def test_plugin_role_does_not_hold_bind_power(self):
        docs = load_manifests("device-plugin-rbac.yaml")
        plugin = role_grants(docs, "tpushare-torch-device-plugin")
        assert "pods/binding" not in plugin
        assert "leases@coordination.k8s.io" not in plugin

    def test_grants_equal_the_jax_manifests(self):
        """Same API calls, same grants: each torch role grants exactly
        what its JAX namesake does."""
        ours = load_manifests("device-plugin-rbac.yaml")
        theirs = load_manifests("device-plugin-rbac.yaml",
                                root=os.path.join(REPO, "deploy"))
        for name in ("tpushare-device-plugin", "tpushare-extender",
                     "tpushare-extender-leases"):
            torch_name = name.replace("tpushare-", "tpushare-torch-", 1)
            assert role_grants(ours, torch_name) == role_grants(theirs, name)


# --------------------------------------------------------------------------
# 2. Wiring
# --------------------------------------------------------------------------

class TestDaemonSetWiring:
    @pytest.fixture()
    def ds(self):
        docs = load_manifests("device-plugin-ds.yaml")
        return next(d for d in docs
                    if d["kind"] == "DaemonSet")["spec"]["template"]["spec"]

    def test_device_plugin_hostpath_matches_socket_dir(self, ds):
        from tpushare_torch import deviceplugin as dp
        want = dp.DEVICE_PLUGIN_PATH.rstrip("/")
        vols = {v["name"]: v for v in ds["volumes"]}
        mounts = {m["name"]: m for m in ds["containers"][0]["volumeMounts"]}
        assert vols["device-plugin"]["hostPath"]["path"].rstrip("/") == want
        assert mounts["device-plugin"]["mountPath"].rstrip("/") == want

    def test_discovery_mounts_match_nvml_backend_defaults(self, ds):
        """/dev for /dev/nvidia<minor>, the PCI tree for AER and NUMA:
        each mounted from the host at the path the backend reads."""
        from tpushare_torch.plugin import health
        from tpushare_torch.plugin.nvmldisc import NvmlBackend
        be = NvmlBackend()
        mounts = {m["name"]: m for m in ds["containers"][0]["volumeMounts"]}
        vols = {v["name"]: v["hostPath"]["path"] for v in ds["volumes"]}
        assert mounts["dev"]["mountPath"] == be._dev_root == vols["dev"]
        assert (mounts["sys-pci"]["mountPath"] == health.PCI_ROOT
                == be.pci_root == vols["sys-pci"])
        assert all(m.get("readOnly") for n, m in mounts.items()
                   if n != "device-plugin")
        assert "sys-accel" not in mounts

    def test_node_name_downward_api(self, ds):
        envs = {e["name"]: e for e in ds["containers"][0]["env"]}
        assert envs["NODE_NAME"]["valueFrom"]["fieldRef"][
            "fieldPath"] == "spec.nodeName"

    def test_command_flags_parse(self, ds):
        from tpushare_torch.plugin.daemon import build_arg_parser
        cmd = ds["containers"][0]["command"]
        assert cmd[:3] == ["python3", "-m", "tpushare_torch.plugin.daemon"]
        args = build_arg_parser().parse_args(cmd[3:])
        assert args.query_kubelet
        assert args.backend == "nvml"

    def test_probe_ports_match_metrics_flag(self, ds):
        c = ds["containers"][0]
        flag = next(a for a in c["command"] if a.startswith("--metrics-port"))
        port = int(flag.split("=")[1])
        ports = {p.get("name"): p["containerPort"] for p in c["ports"]}
        assert ports["metrics"] == port
        assert c["readinessProbe"]["httpGet"]["port"] == port
        assert c["livenessProbe"]["httpGet"]["port"] == port

    def test_serviceaccount_exists_in_rbac(self, ds):
        docs = load_manifests("device-plugin-rbac.yaml")
        sas = {d["metadata"]["name"] for d in docs
               if d.get("kind") == "ServiceAccount"}
        assert ds["serviceAccount"] in sas

    def test_every_card_visible_to_nvml_without_a_gpu_request(self, ds):
        c = ds["containers"][0]
        envs = {e["name"]: e.get("value") for e in c["env"]}
        assert envs[const.ENV_NVIDIA_VISIBLE_DEVICES] == "all"
        assert envs["NVIDIA_DRIVER_CAPABILITIES"] == "utility"
        assert ds["runtimeClassName"] == "nvidia"
        assert "nvidia.com/gpu" not in json.dumps(c.get("resources", {}))


class TestExtenderWiring:
    @pytest.fixture()
    def docs(self):
        return load_manifests("extender-deployment.yaml")

    def test_command_flags_parse_and_port_matches_service(self, docs):
        from tpushare_torch.extender.__main__ import build_parser
        dep = next(d for d in docs if d["kind"] == "Deployment")
        c = containers(dep)[0]
        assert c["command"][:3] == ["python", "-m", "tpushare_torch.extender"]
        args = build_parser().parse_args(c["command"][3:])
        assert args.leader_elect
        ports = [p["containerPort"] for p in c["ports"]]
        assert args.port in ports
        assert args.metrics_port in ports
        svc = next(d for d in docs if d["kind"] == "Service")
        assert svc["spec"]["ports"][0]["targetPort"] == args.port

    def test_service_selects_leader_only(self, docs):
        svc = next(d for d in docs if d["kind"] == "Service")
        assert svc["spec"]["selector"].get("tpushare-role") == "leader"

    def test_leader_election_env_present(self, docs):
        dep = next(d for d in docs if d["kind"] == "Deployment")
        c = containers(dep)[0]
        assert {"POD_NAME", "POD_NAMESPACE"} <= {e["name"] for e in c["env"]}
        assert "--leader-elect" in c["command"]
        assert dep["spec"]["replicas"] >= 2

    def test_lease_apart_from_the_jax_extender(self, docs):
        """Two extenders in one cluster must not contend for one
        Lease: the torch one names its own."""
        from tpushare_torch.extender.__main__ import build_parser
        dep = next(d for d in docs if d["kind"] == "Deployment")
        args = build_parser().parse_args(containers(dep)[0]["command"][3:])
        theirs = next(d for d in load_manifests(
            "extender-deployment.yaml", root=os.path.join(REPO, "deploy"))
            if d["kind"] == "Deployment")
        jargs = build_parser().parse_args(containers(theirs)[0]["command"][3:])
        assert args.lease_name != jargs.lease_name


class TestServeWiring:
    @pytest.fixture()
    def sts(self):
        docs = load_manifests("serve-deployment.yaml")
        return next(d for d in docs if d["kind"] == "StatefulSet")

    def test_command_flags_parse_and_port_is_declared(self, sts):
        from tpushare_torch.cli.serve import build_parser
        c = containers(sts)[0]
        assert c["command"][:3] == ["python3", "-m",
                                    "tpushare_torch.cli.serve"]
        args = build_parser().parse_args(c["command"][3:])
        assert args.port in [p["containerPort"] for p in c["ports"]]
        assert (args.preset, args.n_slots, args.tick_deadline_ms) == (
            "tiny", 8, 500)

    def test_probe_split_liveness_vs_readiness(self, sts):
        from tpushare_torch.cli.serve import build_parser
        c = containers(sts)[0]
        assert c["livenessProbe"]["httpGet"]["path"] == "/healthz"
        assert c["readinessProbe"]["httpGet"]["path"] == "/readyz"
        args = build_parser().parse_args(c["command"][3:])
        assert c["livenessProbe"]["httpGet"]["port"] == args.port
        assert c["readinessProbe"]["httpGet"]["port"] == args.port

    def test_stable_identity_for_affinity(self, sts):
        docs = load_manifests("serve-deployment.yaml")
        svc = next(d for d in docs if d["kind"] == "Service")
        assert svc["spec"]["clusterIP"] == "None"
        assert sts["spec"]["serviceName"] == svc["metadata"]["name"]

    def test_drain_hook_env_is_the_plugin_contract(self, sts):
        from tpushare_torch.plugin.health import ENV_DRAIN_URL
        envs = {e["name"]: e.get("value") for e in containers(sts)[0]["env"]}
        assert envs[ENV_DRAIN_URL].endswith("/drain")

    def test_card_from_tpu_mem_under_the_nvidia_runtime(self, sts):
        """The card comes from Allocate's NVIDIA_VISIBLE_DEVICES, which
        only the NVIDIA runtime acts on: the pod asks for tpu-mem alone
        and names the runtime class."""
        c = containers(sts)[0]
        assert list(c["resources"]["limits"]) == [const.RESOURCE_NAME]
        assert sts["spec"]["template"]["spec"]["runtimeClassName"] == "nvidia"


class TestRouterWiring:
    @pytest.fixture()
    def docs(self):
        return load_manifests("router-deployment.yaml")

    def test_command_flags_parse_and_port_matches_service(self, docs):
        from tpushare_torch.router.daemon import build_arg_parser
        dep = next(d for d in docs if d["kind"] == "Deployment")
        c = containers(dep)[0]
        assert c["command"][:3] == ["python3", "-m",
                                    "tpushare_torch.router.daemon"]
        args = build_arg_parser().parse_args(c["command"][3:])
        assert args.port in [p["containerPort"] for p in c["ports"]]
        svc = next(d for d in docs if d["kind"] == "Service")
        assert svc["spec"]["ports"][0]["targetPort"] == args.port

    def test_probes_hit_router_liveness_and_readiness(self, docs):
        dep = next(d for d in docs if d["kind"] == "Deployment")
        c = containers(dep)[0]
        assert c["livenessProbe"]["httpGet"]["path"] == "/healthz"
        assert c["readinessProbe"]["httpGet"]["path"] == "/readyz"

    def test_replica_urls_name_the_serve_statefulset(self, docs):
        from tpushare_torch.cli.serve import build_parser
        from tpushare_torch.router.daemon import build_arg_parser
        dep = next(d for d in docs if d["kind"] == "Deployment")
        args = build_arg_parser().parse_args(containers(dep)[0]["command"][3:])
        sts = next(d for d in load_manifests("serve-deployment.yaml")
                   if d["kind"] == "StatefulSet")
        serve_args = build_parser().parse_args(containers(sts)[0]["command"][3:])
        svc_name = sts["spec"]["serviceName"]
        urls = [u.strip() for u in args.replicas.split(",")]
        assert len(urls) == sts["spec"]["replicas"]
        for i, u in enumerate(urls):
            host, _, port = u[len("http://"):].partition(":")
            assert host == f"{sts['metadata']['name']}-{i}.{svc_name}"
            assert int(port) == serve_args.port


# --------------------------------------------------------------------------
# 3. The GPU contract across every manifest
# --------------------------------------------------------------------------

class TestPortContract:
    @pytest.mark.parametrize("name", MANIFESTS)
    def test_no_gpu_request_and_no_jax_module(self, name):
        with open(os.path.join(DEPLOY, name)) as f:
            text = f.read()
        for doc in load_manifests(name):
            for c in containers(doc):
                assert "nvidia.com/gpu" not in json.dumps(c.get("resources", {}))
                cmd = c.get("command", [])
                if "-m" in cmd:
                    module = cmd[cmd.index("-m") + 1]
                    assert module.startswith("tpushare_torch."), module
        assert not re.search(r"(?<![\w/])tpushare\.\w", text), name

    def test_object_names_apart_from_the_jax_manifests(self):
        def names(docs):
            return {(d["kind"], d["metadata"]["name"]) for d in docs}
        ours = names(load_manifests(*MANIFESTS))
        theirs = names(load_manifests(*MANIFESTS,
                                      root=os.path.join(REPO, "deploy")))
        assert len(ours) == len(theirs)
        assert not ours & theirs
        assert all("tpushare-torch-" in n for _, n in ours)

    def test_dockerfile_copies_the_port_only(self):
        with open(os.path.join(DEPLOY, "Dockerfile")) as f:
            lines = [l for l in f.read().splitlines()
                     if l.strip() and not l.lstrip().startswith("#")]
        copies = [l.split()[1] for l in lines if l.startswith("COPY")]
        assert "tpushare_torch/" in copies
        assert not any(c.rstrip("/") in ("tpushare", "native") for c in copies)
        assert not any("make" in l.split() for l in lines if l.startswith("RUN"))
        assert lines[-1] == ('ENTRYPOINT ["python", "-m", '
                             '"tpushare_torch.plugin.daemon"]')
        assert lines[0].startswith("FROM pytorch/pytorch:")


# --------------------------------------------------------------------------
# 4. demo/binpack-1 through the port's extender core
# --------------------------------------------------------------------------

class TestBinpackDemo:
    def test_binpack_demo_schedules_onto_one_card(self):
        from tpushare_torch.extender import core
        with open(os.path.join(REPO, "demo", "binpack-1",
                               "binpack-1.yaml")) as f:
            docs = [d for d in yaml.safe_load_all(f) if d]
        sts = next(d for d in docs if d["kind"] == "StatefulSet")
        replicas = sts["spec"]["replicas"]
        limits = containers(sts)[0]["resources"]["limits"]
        assert list(limits) == [const.RESOURCE_NAME]
        mem = int(limits[const.RESOURCE_NAME])
        node = Node(make_node("node-1",
                              capacity={const.RESOURCE_NAME: 16,
                                        const.RESOURCE_COUNT: 1}))
        pods, placed, t0 = [], [], now_ns()
        for i in range(replicas):
            chips = core.choose_chips(node, pods, mem)
            assert chips is not None, f"replica {i} did not fit"
            placed.append(chips)
            pods.append(Pod(make_pod(f"binpack-1-{i}", mem,
                                     idx=",".join(map(str, chips)),
                                     assume_ns=t0 + i, assigned="true")))
        assert all(c == [0] for c in placed)
        assert core.chip_free(node, pods)[0] == 16 - replicas * mem
