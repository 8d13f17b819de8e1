"""Serve configuration (a copy of ``ray_tpu/serve/config.py``; reference:
``serve/config.py`` AutoscalingConfig / DeploymentConfig)."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional


@dataclasses.dataclass
class AutoscalingConfig:
    """Queue-depth autoscaling (reference:
    ``_private/autoscaling_policy.py:54`` ``get_decision_num_replicas``: replicas sized so each sees
    ``target_ongoing_requests`` in flight)."""

    min_replicas: int = 1
    max_replicas: int = 4
    target_ongoing_requests: float = 2.0
    upscale_delay_s: float = 0.5
    downscale_delay_s: float = 2.0
    # Scale decisions use the queue depth AVERAGED over this look-back
    # window, not the instantaneous snapshot (reference:
    # autoscaling_policy.py:54-70 look_back_period_s) — one bursty probe
    # can neither trigger an upscale nor a downscale on its own.
    look_back_period_s: float = 3.0


@dataclasses.dataclass
class DeploymentConfig:
    name: str = ""
    num_replicas: int = 1
    max_ongoing_requests: int = 100
    route_prefix: Optional[str] = None
    autoscaling_config: Optional[AutoscalingConfig] = None
    ray_actor_options: Dict[str, Any] = dataclasses.field(
        default_factory=dict)
    user_config: Any = None
