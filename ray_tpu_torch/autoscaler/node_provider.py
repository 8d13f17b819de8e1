"""NodeProvider plugin interface (port of
``ray_tpu/autoscaler/node_provider.py``; reference:
``autoscaler/node_provider.py:13`` — the cloud-agnostic seam AWS/GCP/
KubeRay implement; ``gpu_pool_provider`` implements it to launch whole GPU
host pools)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional


class NodeProvider:
    """Minimum surface the autoscaler drives. Node ids are opaque strings;
    tags carry node-type / status metadata."""

    def __init__(self, provider_config: Optional[Dict[str, Any]] = None):
        self.provider_config = provider_config or {}

    def non_terminated_nodes(self) -> List[str]:
        raise NotImplementedError

    def create_node(self, node_type: str,
                    node_config: Dict[str, Any], count: int) -> List[str]:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        return node_id in self.non_terminated_nodes()

    def shutdown(self) -> None:
        for nid in list(self.non_terminated_nodes()):
            self.terminate_node(nid)
