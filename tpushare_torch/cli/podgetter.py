"""Debug CLI: dump the local kubelet's /pods list. The port's copy of
``tpushare/cli/podgetter.py`` (the reference's cmd/podgetter/main.go).

Usage: ``python -m tpushare_torch.cli.podgetter [--address A] [--port P] [--token T]``
"""

from __future__ import annotations

import argparse
import json
import sys

from tpushare_torch.k8s.kubelet import KubeletClient
from tpushare_torch.plugin.daemon import SERVICE_ACCOUNT_TOKEN


def main(argv=None, out=sys.stdout) -> int:
    p = argparse.ArgumentParser(prog="tpushare-podgetter", description=__doc__)
    p.add_argument("--address", default="127.0.0.1")
    p.add_argument("--port", type=int, default=10250)
    p.add_argument("--token", default="")
    p.add_argument("--scheme", default="https")
    args = p.parse_args(argv)

    token = args.token
    if not token:
        try:
            with open(SERVICE_ACCOUNT_TOKEN) as f:
                token = f.read().strip()
        except OSError:
            token = None
    client = KubeletClient(host=args.address, port=args.port, token=token,
                           scheme=args.scheme)
    pods = client.get_node_running_pods()
    for pod in pods:
        print(f"{pod.namespace}/{pod.name} phase={pod.phase}", file=out)
    print(json.dumps([p.obj for p in pods])[:2000], file=out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
