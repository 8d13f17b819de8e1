"""Public core API: init/shutdown, tasks, actors, objects.

Role-equivalent to the reference's ``python/ray/_private/worker.py`` public
functions (init :1045, get :2305, put :2452, wait :2514) and
``remote_function.py`` / ``actor.py`` decorators. Implementation lives in
``ray_tpu_torch._private.worker``; this module is the stable surface.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

from ray_tpu_torch._private import worker as _worker_mod
from ray_tpu_torch._private.worker import ObjectRef, ObjectRefGenerator  # noqa: F401


def init(
    address: Optional[str] = None,
    *,
    num_cpus: Optional[int] = None,
    num_gpus: Optional[int] = None,
    resources: Optional[dict] = None,
    object_store_memory: Optional[int] = None,
    namespace: Optional[str] = None,
    ignore_reinit_error: bool = False,
    runtime_env: Optional[dict] = None,
    _system_config: Optional[dict] = None,
    log_to_driver: bool = True,
):
    """Start (or connect to) a ray_tpu_torch cluster and connect this driver."""
    return _worker_mod.init(
        address=address,
        num_cpus=num_cpus,
        num_gpus=num_gpus,
        resources=resources,
        object_store_memory=object_store_memory,
        namespace=namespace,
        ignore_reinit_error=ignore_reinit_error,
        runtime_env=runtime_env,
        system_config=_system_config,
        log_to_driver=log_to_driver,
    )


def shutdown():
    _worker_mod.shutdown()


def is_initialized() -> bool:
    return _worker_mod.global_worker() is not None


def remote(*args, **kwargs):
    """Decorator converting a function into a task / class into an actor."""
    from ray_tpu_torch import remote_decorator

    return remote_decorator.remote(*args, **kwargs)


def method(**kwargs):
    from ray_tpu_torch import remote_decorator

    return remote_decorator.method(**kwargs)


def get(refs, *, timeout: Optional[float] = None):
    return _worker_mod.require_worker().get(refs, timeout=timeout)


def put(value) -> "ObjectRef":
    return _worker_mod.require_worker().put(value)


def wait(
    refs: Sequence["ObjectRef"],
    *,
    num_returns: int = 1,
    timeout: Optional[float] = None,
    fetch_local: bool = True,
) -> Tuple[List["ObjectRef"], List["ObjectRef"]]:
    return _worker_mod.require_worker().wait(
        refs, num_returns=num_returns, timeout=timeout, fetch_local=fetch_local
    )


def cancel(ref: "ObjectRef", *, force: bool = False, recursive: bool = True):
    return _worker_mod.require_worker().cancel(ref, force=force, recursive=recursive)


def kill(actor, *, no_restart: bool = True):
    from ray_tpu_torch.actor import ActorHandle

    if not isinstance(actor, ActorHandle):
        raise TypeError("ray_tpu_torch.kill() expects an actor handle")
    return _worker_mod.require_worker().kill_actor(
        actor._actor_id, no_restart=no_restart)


def get_actor(name: str, namespace: Optional[str] = None):
    from ray_tpu_torch.actor import ActorHandle

    info = _worker_mod.require_worker().get_actor_info_by_name(
        name, namespace=namespace)
    if info is None:
        raise ValueError(f"Failed to look up actor with name '{name}'")
    return ActorHandle(info["actor_id"], class_name=info.get("class_name", ""))


def get_runtime_context():
    from ray_tpu_torch.runtime_context import RuntimeContext

    return RuntimeContext(_worker_mod.require_worker())


def available_resources() -> dict:
    return _worker_mod.require_worker().available_resources()


def cluster_resources() -> dict:
    return _worker_mod.require_worker().cluster_resources()


def nodes() -> List[dict]:
    return _worker_mod.require_worker().nodes()


def timeline() -> List[dict]:
    """Task events for profiling (chrome-trace-able)."""
    return _worker_mod.require_worker().timeline()
