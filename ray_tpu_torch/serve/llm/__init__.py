"""LLM serving on the port (port of ``ray_tpu.serve.llm``), combined or
disaggregated, on the runtime seam.

The continuous-batching engine (``engine``) over the paged or slotted KV
cache of ``models.generate`` and its host-side block pool (``paged``);
prefill, decode and combined deployment classes (``replicas``); the KV
handoff through the runtime's store, out of band as device objects
(``kv_transfer``); and the router with ``build_llm_app`` (``router``). The
modules that drive actors or the store take the runtime as an argument: a
``LocalRuntime`` (in process) by default, or the ``ray_tpu`` module.
"""

from ray_tpu_torch.serve.llm.engine import (  # noqa: F401
    EngineConfig,
    InflightBatchEngine,
)
from ray_tpu_torch.serve.llm.kv_transfer import (  # noqa: F401
    adopt_kv,
    publish_kv,
)
from ray_tpu_torch.serve.llm.paged import BlockPool  # noqa: F401
from ray_tpu_torch.serve.llm.replicas import (  # noqa: F401
    DecodeReplica,
    LLMReplica,
    PrefillReplica,
)
from ray_tpu_torch.serve.llm.router import (  # noqa: F401
    LLMRouter,
    build_llm_app,
)

__all__ = [
    "EngineConfig", "InflightBatchEngine", "LLMReplica", "PrefillReplica",
    "DecodeReplica", "LLMRouter", "build_llm_app", "publish_kv",
    "adopt_kv", "BlockPool",
]
