"""tpushare-torch-device-plugin, the port's device-plugin daemon: the
port's copy of ``tpushare/plugin/daemon.py`` (the reference plugin's
cmd/nvidia/main.go flag surface, main.go:15-26, plus --backend and
--device-plugin-path). In a cluster it reads the serviceaccount token for
the kubelet client when no credentials are given (main.go:28-36).

One definition changes, ``build_arg_parser``: ``--backend`` takes the
port's discovery backends (``fake|nvml|torch``; default: the fake only
when ``TPUSHARE_FAKE_CHIPS`` is set, else NVML) and ``--device-nodes``
names the card's nodes (``/dev/nvidia*``).

Run: ``python -m tpushare_torch.plugin.daemon [flags]``; on the CPU,
``TPUSHARE_FAKE_CHIPS=2 ... --backend fake``.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

from tpushare_torch import deviceplugin as dp
from tpushare_torch.k8s.client import KubeClient
from tpushare_torch.k8s.kubelet import KubeletClient
from tpushare_torch.plugin import const
from tpushare_torch.plugin.backend import auto_backend
from tpushare_torch.plugin.manager import SharedTpuManager

SERVICE_ACCOUNT_TOKEN = "/var/run/secrets/kubernetes.io/serviceaccount/token"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpushare-torch-device-plugin",
                                description=__doc__)
    # flag parity with cmd/nvidia/main.go:15-26 ("--mps" is accepted for
    # CLI compat but, like the reference, never read)
    p.add_argument("--mps", action="store_true",
                   help="accepted for gpushare CLI compatibility; unused")
    p.add_argument("--health-check", action="store_true",
                   help="enable chip health polling")
    p.add_argument("--memory-unit", default="GiB",
                   help="memory unit for tpu-mem fake devices (GiB|MiB)")
    p.add_argument("--query-kubelet", action="store_true",
                   help="query pending pods from kubelet instead of apiserver")
    p.add_argument("--kubelet-address", default="0.0.0.0")
    p.add_argument("--kubelet-port", type=int, default=10250)
    p.add_argument("--client-cert", default="")
    p.add_argument("--client-key", default="")
    p.add_argument("--token", default="")
    p.add_argument("--timeout", type=int, default=10,
                   help="kubelet client http timeout seconds")
    # additions over the reference's flags
    p.add_argument("--backend", default="",
                   help="discovery backend: fake|nvml|torch (default: "
                        "fake when TPUSHARE_FAKE_CHIPS is set, else nvml)")
    p.add_argument("--device-plugin-path", default=dp.DEVICE_PLUGIN_PATH)
    p.add_argument("--device-nodes", default="on", choices=("on", "off"),
                   help="inject /dev/nvidia* DeviceSpec entries (the "
                        "card's node, nvidiactl, nvidia-uvm) in Allocate "
                        "responses so tenant pods reach their card "
                        "without the NVIDIA container runtime (off = "
                        "env-only: the runtime mounts devices itself)")
    p.add_argument("--v", type=int, default=2, help="log verbosity (glog-style)")
    p.add_argument("--metrics-port", type=int, default=0,
                   help="serve Prometheus /metrics and /healthz on this "
                        "port (0 = disabled; no reference analog)")
    return p


def build_kubelet_client(args: argparse.Namespace) -> KubeletClient:
    """Reference: buildKubeletClient (main.go:28-53) — falls back to the
    serviceaccount token in-cluster."""
    token = args.token
    if not (args.client_cert or args.client_key or token):
        try:
            with open(SERVICE_ACCOUNT_TOKEN) as f:
                token = f.read().strip()
        except OSError as e:
            raise SystemExit(f"in cluster mode, find token failed: {e}")
    return KubeletClient(host=args.kubelet_address, port=args.kubelet_port,
                         token=token or None,
                         cert_file=args.client_cert or None,
                         key_file=args.client_key or None,
                         timeout=args.timeout)


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.v >= 4 else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s] %(message)s",
        stream=sys.stderr)
    log = logging.getLogger("tpushare.daemon")
    log.info("start tpushare device plugin")

    node_name = os.environ.get("NODE_NAME", "")
    if not node_name:
        log.fatal("please set env NODE_NAME")  # podmanager.go:55-58
        return 1

    try:
        memory_unit = const.normalize_memory_unit(args.memory_unit)
    except ValueError:
        log.warning("unsupported memory unit %s, using GiB", args.memory_unit)
        memory_unit = const.GIB

    if args.metrics_port:
        from tpushare_torch.plugin.metrics import make_metrics_server
        make_metrics_server(port=args.metrics_port)
        log.info("metrics on :%d/metrics, health on :%d/healthz",
                 args.metrics_port, args.metrics_port)

    kubelet = build_kubelet_client(args)
    kube = KubeClient()
    backend = auto_backend(args.backend) if args.backend else None
    mgr = SharedTpuManager(
        kube, node_name, backend=backend, kubelet=kubelet,
        memory_unit=memory_unit, health_check=args.health_check,
        query_kubelet=args.query_kubelet,
        device_plugin_path=args.device_plugin_path,
        device_nodes=(args.device_nodes == "on"))
    mgr.run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
