"""Fake multi-node provider (port of
``ray_tpu/autoscaler/fake_provider.py``; reference:
``autoscaler/_private/fake_multi_node/node_provider.py`` — autoscaler
e2e without a cloud). "Launching a node" starts a real in-process
``NodeManager`` that registers with the GCS, so scheduling genuinely
spills onto autoscaled nodes."""

from __future__ import annotations

import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.cluster_utils import Cluster


class FakeMultiNodeProvider(NodeProvider):
    def __init__(self, cluster: Cluster,
                 provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config)
        self.cluster = cluster
        self._nodes: Dict[str, Any] = {}   # provider node id -> NodeManager
        self._tags: Dict[str, Dict[str, str]] = {}

    def non_terminated_nodes(self) -> List[str]:
        return list(self._nodes.keys())

    def create_node(self, node_type: str, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        out = []
        for _ in range(count):
            nm = self.cluster.add_node(
                num_cpus=node_config.get("CPU", 1),
                num_gpus=node_config.get("GPU", 0),
                resources={k: v for k, v in node_config.items()
                           if k not in ("CPU", "GPU")},
            )
            nid = f"fake-{node_type}-{uuid.uuid4().hex[:8]}"
            self._nodes[nid] = nm
            self._tags[nid] = {"node-type": node_type,
                               "gcs-node-id": nm.node_id}
            out.append(nid)
        return out

    def terminate_node(self, node_id: str) -> None:
        nm = self._nodes.pop(node_id, None)
        self._tags.pop(node_id, None)
        if nm is not None:
            self.cluster.remove_node(nm)

    def node_tags(self, node_id: str) -> Dict[str, str]:
        return dict(self._tags.get(node_id, {}))
