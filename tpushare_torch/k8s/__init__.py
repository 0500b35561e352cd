"""Minimal Kubernetes clients: the port's copy of ``tpushare/k8s``
(typed views, the apiserver REST client, Events, the kubelet ``/pods``
client), no external kubernetes SDK.
"""

from .types import Node, Pod, parse_quantity  # noqa: F401
from .client import ApiError, KubeClient  # noqa: F401
