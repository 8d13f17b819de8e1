"""Task / actor specifications and resource sets.

Role-equivalent to the reference's ``TaskSpecification``
(reference: src/ray/common/task/task_spec.h) and the option schema in
``python/ray/_private/ray_option_utils.py``. Specs are plain picklable
dataclasses; the function/class payloads are cloudpickled once and cached in
the GCS function store (reference: python/ray/_private/function_manager.py:181)
so repeat submissions ship only the function key.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._private.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID

# Resource names. GPU takes the place the JAX package gives its TPU
# chips: whole devices, handed to a worker as ``CUDA_VISIBLE_DEVICES``.
CPU = "CPU"
GPU = "GPU"
MEMORY = "memory"
OBJECT_STORE_MEMORY = "object_store_memory"


def normalize_resources(
    num_cpus: Optional[float] = None,
    num_gpus: Optional[float] = None,
    memory: Optional[float] = None,
    resources: Optional[Dict[str, float]] = None,
    default_cpus: float = 1.0,
) -> Dict[str, float]:
    """Merge the convenience kwargs into one resource dict. GPUs are
    whole devices, as the reference's chips are."""
    out: Dict[str, float] = {}
    out[CPU] = float(num_cpus) if num_cpus is not None else default_cpus
    if num_gpus:
        if float(num_gpus) != int(num_gpus) or num_gpus < 0:
            raise ValueError(
                f"num_gpus must be a whole number of GPUs, got {num_gpus!r}")
        out[GPU] = float(num_gpus)
    if memory:
        out[MEMORY] = float(memory)
    for k, v in (resources or {}).items():
        if k in (CPU, GPU):
            raise ValueError(
                f"Use num_cpus/num_gpus instead of resources[{k!r}]")
        out[k] = float(v)
    return {k: v for k, v in out.items() if v != 0 or k == CPU}


class ResourceSet:
    """Fixed-point resource arithmetic (reference:
    src/ray/raylet/scheduling/fixed_point.h — resources are integers
    scaled by 1e4, so repeated fractional acquire/release cycles restore
    EXACTLY; float drift like 0.1+0.2 can never wedge a bundle)."""

    __slots__ = ("_r",)
    SCALE = 10_000          # reference: kResourceUnitScaling = 10000

    @classmethod
    def _fp(cls, v: float) -> int:
        return round(float(v) * cls.SCALE)

    def __init__(self, resources: Optional[Dict[str, float]] = None):
        self._r: Dict[str, int] = {
            k: self._fp(v) for k, v in (resources or {}).items()}

    def get(self, name: str) -> float:
        return self._r.get(name, 0) / self.SCALE

    def to_dict(self) -> Dict[str, float]:
        return {k: v / self.SCALE for k, v in self._r.items()}

    def fits(self, demand: Dict[str, float]) -> bool:
        return all(self._r.get(k, 0) >= self._fp(v)
                   for k, v in demand.items())

    def acquire(self, demand: Dict[str, float]) -> bool:
        if not self.fits(demand):
            return False
        for k, v in demand.items():
            self._r[k] = self._r.get(k, 0) - self._fp(v)
        return True

    def release(self, demand: Dict[str, float]) -> None:
        for k, v in demand.items():
            self._r[k] = self._r.get(k, 0) + self._fp(v)

    def subtract(self, demand: Dict[str, float]) -> None:
        """``acquire`` without the fits check: the view may go negative.
        Used for mirrored accounting (a node manager reflecting grants
        made elsewhere): an oversubscribed view simply fails ``fits()``
        until the matching release lands — never wedges."""
        for k, v in demand.items():
            self._r[k] = self._r.get(k, 0) - self._fp(v)

    def is_zero(self) -> bool:
        return all(v == 0 for v in self._r.values())

    def minus_clamped(self, other: "ResourceSet") -> "ResourceSet":
        """self - other with negatives clamped to zero (an effective-
        availability view: capacity minus externally-held resources)."""
        out = ResourceSet()
        out._r = {k: max(0, v - other._r.get(k, 0))
                  for k, v in self._r.items()}
        return out

    def add(self, other: Dict[str, float]) -> None:
        for k, v in other.items():
            self._r[k] = self._r.get(k, 0) + self._fp(v)

    def utilization(self, total: "ResourceSet") -> float:
        """Max over resources of used/total (hybrid-policy input)."""
        u = 0.0
        for k, cap in total._r.items():
            if cap > 0:
                u = max(u, (cap - self._r.get(k, 0)) / cap)
        return u

    def __repr__(self):
        return f"ResourceSet({self.to_dict()})"


def demand_overlaps(demand: Dict[str, float],
                    held: Dict[str, float]) -> bool:
    """Does freeing/withholding ``held`` help ``demand`` at all?
    (Revoking a CPU lease cannot unstick a GPU-shaped task.) Shared by
    the GCS's revoke targeting and the node manager's backoff/revoke
    targeting — the two ends of the lease-fairness protocol must agree."""
    return any(held.get(k, 0) > 0 for k, v in demand.items() if v > 0)


@dataclass
class TaskSpec:
    """A normal-task invocation (reference: common/task/task_spec.h)."""

    task_id: TaskID
    job_id: JobID
    function_key: str          # GCS function-store key
    args: bytes                # framed serialized (args, kwargs)
    arg_deps: List[ObjectID]   # objects that must be ready before dispatch
    num_returns: Any           # int, or "dynamic" for generator tasks
    resources: Dict[str, float]
    name: str = ""
    max_retries: int = 0
    retries_left: int = 0
    caller_id: str = ""        # client id of the submitter (owner)
    owner_node: Optional[str] = None
    scheduling_strategy: Any = None
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    runtime_env: Optional[dict] = None
    # Device-object donation (@remote(_donate_result=True)): the executing
    # worker releases the storage of the producer's returned tensor the
    # moment the return value finishes staging into the arena — device
    # memory goes back to PyTorch's caching allocator without waiting for
    # GC, for producers that hand off and move on. Rides the spec through
    # both the lease direct-transport path and the GCS-scheduled path
    # (worker_main._store_returns honors it on either).
    donate_result: bool = False
    submitted_at: float = field(default_factory=time.time)
    # {trace_id, parent_span_id}: carried across hops so task events form
    # a distributed trace (reference: tracing_helper.py:284 _ray_trace_ctx).
    trace_ctx: Optional[Dict[str, Any]] = None
    # ObjectRefs nested inside the args (a list of refs, say): never
    # waited for, but pinned with arg_deps while the task is in flight,
    # so a task that waits in a queue still finds them (pinned_deps).
    nested_deps: Tuple[ObjectID, ...] = ()

    def return_ids(self) -> List[ObjectID]:
        # Memoized: the submit hot path derives these at least twice
        # (caller refs + lease bookkeeping). Dropped from the pickled
        # state (__getstate__) so specs don't carry it on the wire.
        rids = self.__dict__.get("_rids")
        if rids is None:
            if self.num_returns == "dynamic":
                # One visible return: the ObjectRefGenerator. The
                # yielded values get indices 1..N at execution time
                # (reference: task manager dynamic returns,
                # num_returns="dynamic").
                rids = [ObjectID.for_return(self.task_id, 0)]
            else:
                rids = [ObjectID.for_return(self.task_id, i)
                        for i in range(self.num_returns)]
            self.__dict__["_rids"] = rids
        return rids

    # Compact pickle state: a TUPLE in field order instead of the
    # dataclass __dict__ — specs are the payload of every scheduling
    # message (submit waves pickle them by the hundred-thousand), and
    # dropping the 19 field-name strings per spec cuts both dumps and
    # loads time. Also drops the _rids memo from the wire.
    _STATE_FIELDS = (
        "task_id", "job_id", "function_key", "args", "arg_deps",
        "num_returns", "resources", "name", "max_retries", "retries_left",
        "caller_id", "owner_node", "scheduling_strategy",
        "placement_group_id", "placement_group_bundle_index",
        "runtime_env", "donate_result", "submitted_at", "trace_ctx",
        "nested_deps")

    def __getstate__(self):
        return tuple(getattr(self, f) for f in self._STATE_FIELDS)

    def __setstate__(self, state):
        if isinstance(state, dict):     # older snapshot (gcs storage)
            self.__dict__.update(state)
            self.__dict__.pop("_rids", None)
            return
        for f, v in zip(self._STATE_FIELDS, state):
            self.__dict__[f] = v


@dataclass
class ActorCreationSpec:
    """Actor creation (reference: gcs_actor_manager.h:281 registration)."""

    actor_id: ActorID
    job_id: JobID
    class_key: str             # GCS function-store key for the pickled class
    args: bytes                # framed serialized (args, kwargs) for __init__
    arg_deps: List[ObjectID]
    resources: Dict[str, float]
    name: Optional[str] = None         # named actor
    namespace: str = "default"
    lifetime: Optional[str] = None     # None | "detached"
    max_restarts: int = 0
    max_task_retries: int = 0
    max_concurrency: int = 1
    max_pending_calls: int = -1
    is_async: bool = False
    caller_id: str = ""
    scheduling_strategy: Any = None
    placement_group_id: Optional[PlacementGroupID] = None
    placement_group_bundle_index: int = -1
    runtime_env: Optional[dict] = None
    class_name: str = ""
    # Driver's sys.path dirs at creation time: a prestarted pool worker
    # (spawned before the driver extended its path) prepends missing
    # entries so by-reference class pickles resolve (reference:
    # runtime_env working_dir ships driver code; same-host equivalent).
    sys_path: Optional[List[str]] = None
    trace_ctx: Optional[Dict[str, Any]] = None   # see TaskSpec.trace_ctx
    # See TaskSpec.nested_deps: pinned by the GCS from registration until
    # the constructor has run with no restart left, or the actor has died.
    nested_deps: Tuple[ObjectID, ...] = ()


@dataclass
class ActorTaskSpec:
    """One actor method invocation (pushed caller -> actor node -> worker)."""

    task_id: TaskID
    actor_id: ActorID
    job_id: JobID
    method_name: str
    args: bytes
    arg_deps: List[ObjectID]
    num_returns: int
    caller_id: str = ""
    seqno: int = 0
    concurrency_group: str = ""
    retries_left: int = 0
    trace_ctx: Optional[Dict[str, Any]] = None   # see TaskSpec.trace_ctx
    nested_deps: Tuple[ObjectID, ...] = ()       # see TaskSpec.nested_deps

    def return_ids(self) -> List[ObjectID]:
        return [ObjectID.for_return(self.task_id, i)
                for i in range(self.num_returns)]


def pinned_deps(spec) -> List[ObjectID]:
    """The objects a spec in flight keeps alive: its arguments and the
    refs nested inside them."""
    nested = getattr(spec, "nested_deps", ())
    return spec.arg_deps + list(nested) if nested else spec.arg_deps


@dataclass
class Bundle:
    """One placement-group bundle (reference: util/placement_group.py)."""

    index: int
    resources: Dict[str, float]
    node_id: Optional[str] = None   # filled once placed


@dataclass
class PlacementGroupSpec:
    pg_id: PlacementGroupID
    bundles: List[Bundle]
    strategy: str = "PACK"          # PACK|SPREAD|STRICT_PACK|STRICT_SPREAD
    name: str = ""
    lifetime: Optional[str] = None
    caller_id: str = ""
