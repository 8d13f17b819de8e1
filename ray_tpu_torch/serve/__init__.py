"""Serving of the port: the LLM engine (``serve.llm``)."""

from ray_tpu_torch.serve.llm import (  # noqa: F401
    BlockPool,
    EngineConfig,
    InflightBatchEngine,
)

__all__ = ["EngineConfig", "InflightBatchEngine", "BlockPool"]
