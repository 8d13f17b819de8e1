"""Cluster YAML launcher — the ``ray up`` analog (port of
``ray_tpu/autoscaler/cluster_launcher.py``; reference:
``autoscaler/_private/commands.py`` create_or_update_cluster +
the cluster YAML schema ``autoscaler/ray-schema.json``).

YAML shape (a subset of the reference's schema):

    cluster_name: demo
    max_workers: 4
    idle_timeout_s: 30
    provider:
      type: local_process            # | fake (in-process, tests)
      object_store_memory: 268435456
    head_node_type:
      CPU: 2
    available_node_types:
      cpu_worker:
        resources: {CPU: 2}
        min_workers: 1
        max_workers: 4

``launch_cluster(config)`` starts (or joins) the head, builds the
provider + StandardAutoscaler, and returns a handle whose ``shutdown``
tears everything down.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from ray_tpu_torch.autoscaler.autoscaler import (
    AutoscalerConfig, NodeType, StandardAutoscaler,
)
from ray_tpu_torch.autoscaler.local_provider import LocalProcessNodeProvider


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    if not cfg.get("available_node_types"):
        raise ValueError("cluster YAML needs available_node_types")
    return cfg


@dataclasses.dataclass
class LaunchedCluster:
    address: str
    autoscaler: StandardAutoscaler
    provider: Any
    cluster: Any = None          # _LocalCluster when we started the head

    def shutdown(self):
        self.autoscaler.stop()
        try:
            self.provider.shutdown()
        except Exception:
            pass
        if self.cluster is not None:
            self.cluster.shutdown()


def launch_cluster(config: Dict[str, Any],
                   gcs_address: Optional[str] = None) -> LaunchedCluster:
    """Start the head (unless joining ``gcs_address``), the node
    provider, and the autoscaler; min_workers launch on the first
    reconcile."""
    from ray_tpu_torch._private import protocol, worker as worker_mod

    cluster = None
    if gcs_address is None:
        head = dict(config.get("head_node_type") or {})
        cluster = worker_mod._LocalCluster(
            head.get("CPU", 2), head.get("GPU", 0),
            {k: v for k, v in head.items() if k not in ("CPU", "GPU")}
            or None,
            int(config.get("provider", {}).get(
                "object_store_memory", 256 << 20)))
        gcs_address = cluster.address

    provider_cfg = dict(config.get("provider") or {})
    ptype = provider_cfg.pop("type", "local_process")
    if ptype == "local_process":
        provider = LocalProcessNodeProvider(gcs_address, provider_cfg)
    else:
        raise ValueError(f"unknown provider type {ptype!r} "
                         f"(cloud/GPU-pool providers implement NodeProvider)")

    node_types = [
        NodeType(name=name,
                 resources=dict(nt.get("resources") or {}),
                 min_workers=int(nt.get("min_workers", 0)),
                 max_workers=int(nt.get("max_workers", 10)))
        for name, nt in config["available_node_types"].items()
    ]
    as_cfg = AutoscalerConfig(
        node_types=node_types,
        max_workers=int(config.get("max_workers", 10)),
        idle_timeout_s=float(config.get("idle_timeout_s", 60.0)),
        update_interval_s=float(config.get("update_interval_s", 1.0)),
    )
    gcs_conn = protocol.connect(gcs_address, name="autoscaler")
    autoscaler = StandardAutoscaler(gcs_conn, provider, as_cfg)
    autoscaler.run_once()   # launch min_workers before returning
    autoscaler.start()
    return LaunchedCluster(address=gcs_address, autoscaler=autoscaler,
                           provider=provider, cluster=cluster)
