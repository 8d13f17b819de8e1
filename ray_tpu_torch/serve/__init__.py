"""Serving of the port: the LLM tier (``serve.llm``) and the client-side
request migration it rides (``serve.migration``)."""

from ray_tpu_torch.serve.llm import (  # noqa: F401
    BlockPool,
    DecodeReplica,
    EngineConfig,
    InflightBatchEngine,
    LLMReplica,
    LLMRouter,
    PrefillReplica,
    build_llm_app,
)

__all__ = ["EngineConfig", "InflightBatchEngine", "BlockPool", "LLMReplica",
           "PrefillReplica", "DecodeReplica", "LLMRouter", "build_llm_app"]
