"""Actor classes and handles.

Role-equivalent to the reference's ``python/ray/actor.py``
(ActorClass :377, ``_remote`` :659, ActorHandle :1020, ActorMethod :137).
Handles are picklable: a deserialized handle reconnects to the actor through
the GCS directory, and method calls are pushed directly to the actor's node
manager (reference: direct_actor_task_submitter.h:67 — no GCS on the hot
path once the route is cached).
"""

from __future__ import annotations

import inspect
from typing import Any, Dict, Optional

from ray_tpu_torch._private import pickler

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.ids import ActorID
from ray_tpu_torch._private.task_spec import normalize_resources
from ray_tpu_torch import exceptions

_ACTOR_DEFAULTS = dict(
    num_cpus=None,
    num_gpus=None,
    memory=None,
    resources=None,
    name=None,
    namespace=None,
    lifetime=None,
    max_restarts=0,
    max_task_retries=0,
    max_concurrency=None,
    max_pending_calls=-1,
    scheduling_strategy=None,
    placement_group=None,
    placement_group_bundle_index=-1,
    runtime_env=None,
    _metadata=None,
)


def _merge(base, overrides):
    out = dict(base)
    for k, v in overrides.items():
        if k not in _ACTOR_DEFAULTS:
            raise ValueError(f"unknown actor option: {k}")
        out[k] = v
    return out


def method(**options):
    """Per-method option decorator (reference: actor.py ``@ray.method``)."""

    def decorator(fn):
        fn.__ray_tpu_method_options__ = options
        return fn

    return decorator


class ActorMethod:
    def __init__(self, handle: "ActorHandle", name: str,
                 num_returns: int = 1):
        self._handle = handle
        self._name = name
        self._num_returns = num_returns

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method '{self._name}' cannot be called directly; use "
            f"'.remote()'.")

    def options(self, num_returns: Optional[int] = None, **_ignored):
        return ActorMethod(
            self._handle, self._name,
            num_returns if num_returns is not None else self._num_returns)

    def remote(self, *args, **kwargs):
        core = worker_mod.require_worker()
        refs = core.submit_actor_task(
            self._handle._actor_id, self._name, args, kwargs,
            num_returns=self._num_returns)
        if self._num_returns == 0:
            return None
        if self._num_returns == 1:
            return refs[0]
        return refs


class ActorHandle:
    def __init__(self, actor_id: ActorID,
                 method_meta: Optional[Dict[str, dict]] = None,
                 class_name: str = ""):
        self._actor_id = actor_id
        self._method_meta = method_meta or {}
        self._class_name = class_name

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        meta = self._method_meta.get(name, {})
        return ActorMethod(self, name, meta.get("num_returns", 1))

    def __repr__(self):
        return (f"Actor({self._class_name}, {self._actor_id.hex()[:16]})")

    def __hash__(self):
        return hash(self._actor_id)

    def __eq__(self, other):
        return isinstance(other, ActorHandle) and \
            other._actor_id == self._actor_id

    def __reduce__(self):
        return (_restore_handle,
                (self._actor_id.binary(), self._method_meta,
                 self._class_name))

    # internal terminator used by ray_tpu_torch.kill / exit_actor
    def _graceful_exit(self):
        return ActorMethod(self, "__ray_terminate__", 1).remote()


def _restore_handle(actor_id_bytes, method_meta, class_name):
    return ActorHandle(ActorID(actor_id_bytes), method_meta, class_name)


class ActorClass:
    def __init__(self, cls, options: Optional[Dict[str, Any]] = None):
        self._cls = cls
        self._options = _merge(_ACTOR_DEFAULTS, options or {})
        self._exported_blob: Optional[bytes] = None
        self.__name__ = cls.__name__
        self.__qualname__ = getattr(cls, "__qualname__", cls.__name__)
        self.__doc__ = cls.__doc__

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class '{self._cls.__name__}' cannot be instantiated "
            "directly; use '.remote()'.")

    def options(self, **overrides) -> "ActorClass":
        ac = ActorClass(self._cls, _merge(self._options, overrides))
        ac._exported_blob = self._exported_blob
        return ac

    def _method_meta(self) -> Dict[str, dict]:
        meta = {}
        for name, fn in inspect.getmembers(self._cls,
                                           predicate=callable):
            opts = getattr(fn, "__ray_tpu_method_options__", None)
            if opts:
                meta[name] = dict(opts)
        return meta

    def _is_async(self) -> bool:
        for _, fn in inspect.getmembers(self._cls):
            if inspect.iscoroutinefunction(fn):
                return True
        return False

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = worker_mod.require_worker()
        o = self._options
        if self._exported_blob is None:
            self._exported_blob = pickler.dumps(self._cls)
        key = core.export_function(self._exported_blob)
        # Actors hold 0 CPUs by default so unlimited actors can coexist
        # (reference: ray_option_utils — actor num_cpus defaults to 0 for
        # the actor's lifetime).
        resources = normalize_resources(
            o["num_cpus"], o["num_gpus"], o["memory"],
            o["resources"], default_cpus=0.0)
        is_async = self._is_async()
        max_concurrency = o["max_concurrency"] or (1000 if is_async else 1)
        strategy = o["scheduling_strategy"]
        pg = o["placement_group"]
        bundle_index = o["placement_group_bundle_index"]
        if strategy is not None and hasattr(strategy, "placement_group"):
            pg = strategy.placement_group
            bundle_index = getattr(strategy,
                                   "placement_group_bundle_index", -1)
            strategy = None
        actor_id = core.create_actor(
            key, args, kwargs,
            class_name=self._cls.__name__,
            resources=resources,
            name=o["name"],
            namespace=o["namespace"],
            lifetime=o["lifetime"],
            max_restarts=o["max_restarts"],
            max_task_retries=o["max_task_retries"],
            max_concurrency=max_concurrency,
            is_async=is_async,
            scheduling_strategy=strategy,
            placement_group=pg,
            placement_group_bundle_index=bundle_index,
            runtime_env=o["runtime_env"],
        )
        return ActorHandle(actor_id, self._method_meta(),
                           self._cls.__name__)


def exit_actor():
    """Terminate the current actor from inside one of its methods
    (reference: ray.actor.exit_actor)."""
    core = worker_mod.require_worker()
    if core.ctx.actor_id is None:
        raise RuntimeError("exit_actor() called outside an actor")
    raise SystemExit(0)
