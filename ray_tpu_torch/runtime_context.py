"""Runtime context (reference: python/ray/runtime_context.py)."""

from __future__ import annotations

from typing import Optional


class RuntimeContext:
    def __init__(self, core):
        self._core = core

    def get_job_id(self) -> str:
        return self._core.ctx.job_id.hex() if self._core.ctx.job_id else ""

    def get_task_id(self) -> Optional[str]:
        return self._core.ctx.task_id.hex() if self._core.ctx.task_id else None

    def get_actor_id(self) -> Optional[str]:
        return (self._core.ctx.actor_id.hex()
                if self._core.ctx.actor_id else None)

    def get_node_id(self) -> str:
        return self._core.node_id

    def get_worker_id(self) -> str:
        return self._core.client_id

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get_assigned_resources(self) -> dict:
        """The GPUs the node manager assigned this worker, as
        ``{"GPU": n}``; empty for a CPU worker and the driver."""
        from ray_tpu_torch._private.config import config

        ids = config.refresh_from_env("gpu_ids")
        return {"GPU": float(len(ids.split(",")))} if ids else {}

    def get_runtime_env_string(self) -> str:
        return "{}"
