"""Scheduling strategies (reference: python/ray/util/scheduling_strategies.py
:15 PlacementGroupSchedulingStrategy, :41 NodeAffinitySchedulingStrategy).

Strings are also accepted: "DEFAULT" (hybrid policy) and "SPREAD"
(reference: spread_scheduling_policy.h:27).
"""

from __future__ import annotations

from typing import Optional


class PlacementGroupSchedulingStrategy:
    def __init__(self, placement_group,
                 placement_group_bundle_index: int = -1,
                 placement_group_capture_child_tasks: Optional[bool] = None):
        self.kind = "placement_group"
        self.placement_group = placement_group
        self.placement_group_bundle_index = placement_group_bundle_index
        self.placement_group_capture_child_tasks = \
            placement_group_capture_child_tasks


class NodeAffinitySchedulingStrategy:
    def __init__(self, node_id: str, soft: bool = False):
        self.kind = "node_affinity"
        self.node_id = node_id
        self.soft = soft


class SpreadSchedulingStrategy:
    def __init__(self):
        self.kind = "spread"
