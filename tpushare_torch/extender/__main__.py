"""`python -m tpushare_torch.extender` — run the scheduler extender
(console script ``tpushare-torch-extender``; the port's copy of
``tpushare/extender/__main__.py``)."""

import argparse
import logging

from tpushare_torch.extender.server import make_server
from tpushare_torch.k8s.client import KubeClient


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="tpushare-torch-extender")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=39999)
    ap.add_argument("--prefix", default="/tpushare")
    ap.add_argument("--kubeconfig", default=None)
    ap.add_argument("--leader-elect", action="store_true",
                    help="HA: acquire a coordination.k8s.io Lease; "
                         "followers refuse /bind")
    ap.add_argument("--lease-namespace", default="kube-system")
    ap.add_argument("--lease-name", default="tpushare-extender")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve Prometheus /metrics on this port "
                         "(0 = disabled)")
    ap.add_argument("--pod-cache", action="store_true",
                    help="serve /filter and /prioritize from a "
                         "watch-fed pod cache instead of a LIST per "
                         "call (/bind always reads live)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from tpushare_torch.k8s.client import load_config
    kube = KubeClient(load_config(args.kubeconfig))
    import os
    import socket

    from tpushare_torch.extender.server import METRICS
    elector = None
    if args.leader_elect:
        from tpushare_torch.extender.leader import LeaderElector
        identity = os.environ.get("POD_NAME", socket.gethostname())
        pod_ns = os.environ.get("POD_NAMESPACE", args.lease_namespace)

        def on_change(leader: bool, _name=identity, _ns=pod_ns) -> None:
            METRICS.set("tpushare_extender_is_leader",
                        1.0 if leader else 0.0)
            # Leader-labeled routing: the bind Service selects
            # tpushare-role=leader, so /bind lands on the holder
            # instead of failing ~1/replicas of scheduling cycles on
            # follower refusals (those remain only a label-lag race).
            try:
                kube.patch_pod(_ns, _name, {"metadata": {"labels": {
                    "tpushare-role": "leader" if leader else "follower"}}})
            except Exception as e:
                logging.getLogger("tpushare.extender").warning(
                    "leader label patch failed: %s", e)

        METRICS.set("tpushare_extender_is_leader", 0.0)
        elector = LeaderElector(kube, identity,
                                namespace=args.lease_namespace,
                                name=args.lease_name,
                                on_change=on_change).start()
    else:
        # HA off: this replica is trivially the bind-server.
        METRICS.set("tpushare_extender_is_leader", 1.0)
    if args.metrics_port:
        from tpushare_torch.plugin.metrics import make_metrics_server
        METRICS.ready = True          # extender serves as soon as it binds
        make_metrics_server(METRICS, port=args.metrics_port)
    pod_cache = None
    if args.pod_cache:
        from tpushare_torch.k8s.watch import PodCache
        pod_cache = PodCache(kube).start()
    server = make_server(kube, host=args.host, port=args.port,
                         prefix=args.prefix, elector=elector,
                         pod_cache=pod_cache)
    logging.getLogger("tpushare.extender").info(
        "serving on %s:%d%s", args.host, server.server_address[1],
        args.prefix)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
