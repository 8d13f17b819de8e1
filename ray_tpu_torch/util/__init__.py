"""Utility APIs (reference: python/ray/util/__init__.py)."""

from ray_tpu_torch.util.actor_pool import ActorPool  # noqa: F401
from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    get_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util import scheduling_strategies  # noqa: F401

__all__ = [
    "ActorPool",
    "PlacementGroup",
    "placement_group",
    "remove_placement_group",
    "placement_group_table",
    "get_placement_group",
    "scheduling_strategies",
]
