"""LLM serving on the port (port of ``ray_tpu.serve.llm``): the
continuous-batching engine (``engine``) over the paged or slotted KV cache
of ``models.generate``, and the host-side KV block pool (``paged``). The
replica classes, router and KV handoff ride the reference's runtime and
device objects and are not ported yet."""

from ray_tpu_torch.serve.llm.engine import (  # noqa: F401
    EngineConfig,
    InflightBatchEngine,
)
from ray_tpu_torch.serve.llm.paged import BlockPool  # noqa: F401

__all__ = ["EngineConfig", "InflightBatchEngine", "BlockPool"]
