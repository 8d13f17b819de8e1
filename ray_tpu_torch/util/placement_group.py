"""Placement groups: gang-scheduled resource bundles.

Role-equivalent to the reference's ``python/ray/util/placement_group.py:128``
+ GCS-side manager (reference: gcs_placement_group_manager.h:223) and bundle
scheduling policies (reference:
raylet/scheduling/policy/bundle_scheduling_policy.h:31 — PACK / SPREAD /
STRICT_PACK / STRICT_SPREAD).

GPU note: a bundle with a ``GPU`` resource is the unit of gang
scheduling for SPMD programs — STRICT_PACK keeps a mesh's GPUs on one host
(one NVLink domain), STRICT_SPREAD pins one bundle per host for multi-host
meshes.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import PlacementGroupID
from ray_tpu_torch._private.task_spec import Bundle, PlacementGroupSpec
from ray_tpu_torch.exceptions import PlacementGroupSchedulingError

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: Optional[List[Dict[str, float]]] = None):
        self.id = pg_id
        self._bundles = bundles or []

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return list(self._bundles)

    @property
    def bundle_count(self) -> int:
        return len(self._bundles)

    def ready(self):
        """ObjectRef that resolves when the group is placed (reference:
        placement_group.py ready() — a hidden zero-resource task bound to
        the group)."""
        from ray_tpu_torch import remote_decorator

        @remote_decorator.remote(num_cpus=0, placement_group=self,
                                 max_retries=0)
        def _pg_ready():
            return True

        return _pg_ready.remote()

    def wait(self, timeout_seconds: Optional[float] = 30) -> bool:
        core = worker_mod.require_worker()
        try:
            # Server-parked wait (GCS holds the reply until the PG is
            # CREATED): None means wait() 's documented "no deadline",
            # not the channel's default RPC bound.
            core.gcs.request("wait_pg_ready", {"pg_id": self.id.binary()},
                             timeout=core.gcs.UNBOUNDED
                             if timeout_seconds is None else timeout_seconds)
            return True
        except TimeoutError:
            return False

    def __reduce__(self):
        return (_restore_pg, (self.id, self._bundles))


def _restore_pg(pg_id, bundles):
    return PlacementGroup(pg_id, bundles)


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: str = "",
                    lifetime: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"invalid strategy {strategy!r}; "
                         f"one of {VALID_STRATEGIES}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError("each bundle must be a non-empty dict")
        if any(v < 0 for v in b.values()):
            raise ValueError("bundle resources must be non-negative")
        if all(v == 0 for v in b.values()):
            raise ValueError("bundle must request a positive resource")
    core = worker_mod.require_worker()
    pg_id = PlacementGroupID.of(core.job_id)
    spec = PlacementGroupSpec(
        pg_id=pg_id,
        bundles=[Bundle(index=i, resources=dict(b))
                 for i, b in enumerate(bundles)],
        strategy=strategy,
        name=name,
        lifetime=lifetime,
        caller_id=core.client_id,
    )
    core.gcs.request("create_pg", spec)
    return PlacementGroup(pg_id, [dict(b) for b in bundles])


def remove_placement_group(pg: PlacementGroup) -> None:
    core = worker_mod.require_worker()
    core.gcs.request("remove_pg", {"pg_id": pg.id.binary()})


def placement_group_table(pg: Optional[PlacementGroup] = None) -> dict:
    core = worker_mod.require_worker()
    table = core.gcs.request("pg_table")
    out = {}
    for pid, info in table.items():
        out[pid.hex() if isinstance(pid, bytes) else pid] = info
    if pg is not None:
        return out.get(pg.id.hex(), {})
    return out


def get_placement_group(name: str) -> PlacementGroup:
    core = worker_mod.require_worker()
    table = core.gcs.request("pg_table")
    for pid, info in table.items():
        if info.get("name") == name and info.get("state") != "REMOVED":
            return PlacementGroup(
                PlacementGroupID(pid),
                [b["resources"] for b in info["bundles"]])
    raise ValueError(f"placement group '{name}' not found")
