"""Cluster autoscaler (port of ``ray_tpu/autoscaler``; reference:
``python/ray/autoscaler`` — ``StandardAutoscaler.update``
``_private/autoscaler.py:168,366``, bin-packing
``_private/resource_demand_scheduler.py:103,171``, ``NodeProvider`` plugin
API ``node_provider.py:13``, fake provider
``_private/fake_multi_node/node_provider.py``).

Node types carry whole GPUs and pool labels, so the demand scheduler can
launch whole NVLink host pools for gang-scheduled GPU bundles instead of
loose GPUs. It reads the GCS's pending demand and node table of the
port's own runtime.
"""

from ray_tpu_torch.autoscaler.node_provider import NodeProvider  # noqa: F401
from ray_tpu_torch.autoscaler.fake_provider import (  # noqa: F401
    FakeMultiNodeProvider,
)
from ray_tpu_torch.autoscaler.gpu_pool_provider import (  # noqa: F401
    FakeGpuCloud, GpuPoolCloud, GpuPoolProvider,
)
from ray_tpu_torch.autoscaler.autoscaler import (  # noqa: F401
    AutoscalerConfig, NodeType, StandardAutoscaler,
)

__all__ = ["NodeProvider", "FakeMultiNodeProvider", "StandardAutoscaler",
           "AutoscalerConfig", "NodeType", "GpuPoolProvider", "GpuPoolCloud",
           "FakeGpuCloud"]
