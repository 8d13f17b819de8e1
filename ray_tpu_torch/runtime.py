"""The port's in-process runtime: the calls of the runtime seam with the
signatures of ``ray_tpu/api.py`` (``remote``, ``get``, ``put``, ``wait``,
``kill``, ``get_actor``, ``get_runtime_context``), run in the caller's
process and thread.

The port's modules that drive actors (``rllib``'s algorithms and
``LearnerGroup``) take a runtime as an argument: a ``LocalRuntime`` by
default, or any object with the same calls, such as the ``ray_tpu`` module
itself. Here an actor is a local object, and a call runs when it is made:
``.remote`` returns a ref that is already resolved and holds the result or
the exception, which ``get`` raises, as the real runtime raises at ``get``
and never at ``.remote()``. So ``wait`` finds every ref ready.

Arguments and results pass by value, as they do between the real
runtime's processes: each call works on deep copies of its arguments, and
its ref holds a deep copy of its result. An actor that keeps an argument
(a replay shard's ``add_batch``, a worker's weights) never sees its
caller's later in-place writes, nor the caller the actor's. Actor handles,
refs and the runtime itself pass as themselves.

Calls may come from many threads at once, as a serve app's clients make
them: each thread keeps its own stack of running actors, so
``get_runtime_context`` names the actor that thread is in.

``runtime.serve`` is the in-process counterpart of the ``ray_tpu.serve``
calls the serving tier makes (``deployment``, ``run``, ``delete``,
``get_deployment_handle``, and on a handle ``remote``/``remote_gen``), under
``ray_tpu/serve/api.py``'s and ``handle.py``'s signatures. ``run`` builds a
deployment's ``num_replicas`` instances now, children first; the other
deployment options are taken and ignored, as one process has nothing to
scale or reserve. A handle call runs on the next replica, round robin, in
the caller's thread, with ``.remote`` resolved as an actor call is. A
stream (``remote_gen``) iterates the replica's iterator itself and hands
the caller a copy of each item: a stream holds an engine and its thread,
and is never copied. As ``ray_tpu``'s handle does, a call or stream that
fails with the port's ``EngineFailedError`` is run again (a stream through
its ``_resume`` rewriter, from the items already delivered), up to
``serve_request_max_migrations`` times, each counted by
``serve.migration.note_migration``.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import itertools
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# options() takes these and ignores them: one process has no resources to
# reserve, and nothing for a detached actor to outlive.
_RESOURCE_OPTIONS = frozenset({"num_cpus", "num_gpus", "num_tpus",
                               "lifetime"})


class ActorDiedError(RuntimeError):
    """A method was called on an actor that was killed."""


class ObjectRef:
    """A resolved result: the value, or the exception the call raised."""

    __slots__ = ("_value", "_error", "__weakref__")

    def __init__(self, value: Any = None, error: Optional[BaseException]
                 = None):
        self._value = value
        self._error = error

    def __deepcopy__(self, memo):
        return self


def _check_options(options: Dict[str, Any]) -> None:
    unknown = set(options) - _RESOURCE_OPTIONS
    if unknown:
        raise TypeError(f"unsupported options {sorted(unknown)}")


class RemoteFunction:
    """``remote(fn)``: ``.remote(*args)`` runs ``fn`` on copies of them."""

    def __init__(self, fn: Callable):
        self._fn = fn

    def options(self, **options) -> "RemoteFunction":
        _check_options(options)
        return self

    def remote(self, *args, **kwargs) -> ObjectRef:
        return _run(self._fn, args, kwargs)


def _run(fn: Callable, args, kwargs) -> ObjectRef:
    args, kwargs = copy.deepcopy((args, kwargs))
    try:
        result = fn(*args, **kwargs)
    except Exception as e:  # kept for get(), as the real runtime does
        return ObjectRef(error=e)
    return ObjectRef(copy.deepcopy(result))


class ActorHandle:
    """A local actor. ``handle.method.remote(*args)`` runs the method now;
    after ``kill`` (or when the constructor raised) each call's ref holds
    the error."""

    def __init__(self, runtime: "LocalRuntime", actor_id: str,
                 instance: Any = None,
                 error: Optional[BaseException] = None):
        self._runtime = runtime
        self._actor_id = actor_id
        self._instance = instance
        self._error = error

    def __deepcopy__(self, memo):
        return self

    def __getattr__(self, name: str) -> "_ActorMethod":
        if name.startswith("__"):
            raise AttributeError(name)
        return _ActorMethod(self, name)


class _ActorMethod:
    def __init__(self, handle: ActorHandle, name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs) -> ObjectRef:
        h = self._handle
        if h._error is not None:
            return ObjectRef(error=h._error)
        with h._runtime._in_actor(h._actor_id):
            return _run(getattr(h._instance, self._name), args, kwargs)


class ActorClass:
    """``remote(cls)``: ``.remote(*args)`` constructs the actor now."""

    def __init__(self, runtime: "LocalRuntime", cls: type,
                 name: Optional[str] = None):
        self._runtime = runtime
        self._cls = cls
        self._name = name

    def options(self, *, name: Optional[str] = None,
                **options) -> "ActorClass":
        _check_options(options)
        return ActorClass(self._runtime, self._cls, name)

    def remote(self, *args, **kwargs) -> ActorHandle:
        rt = self._runtime
        if self._name is not None and self._name in rt._named:
            raise ValueError(f"an actor named {self._name!r} exists")
        actor_id = f"{self._cls.__name__}-{next(rt._ids)}"
        args, kwargs = copy.deepcopy((args, kwargs))
        try:
            handle = ActorHandle(rt, actor_id, self._cls(*args, **kwargs))
        except Exception as e:  # raised by get() of every call, as there
            handle = ActorHandle(rt, actor_id, error=e)
        if self._name is not None:
            rt._named[self._name] = handle
        return handle


class RuntimeContext:
    def __init__(self, actor_id: Optional[str]):
        self._actor_id = actor_id

    def get_actor_id(self) -> Optional[str]:
        """The id of the actor whose method is running, None outside."""
        return self._actor_id


class _ActorStack(threading.local):
    def __init__(self):
        self.ids: List[str] = []


class LocalRuntime:
    """The runtime seam's calls in one process (module docstring)."""

    def __init__(self):
        self._named: Dict[str, ActorHandle] = {}
        self._ids = itertools.count()
        self._actor_stack = _ActorStack()
        self.serve = Serve(self)

    def __deepcopy__(self, memo):
        return self

    @contextlib.contextmanager
    def _in_actor(self, actor_id: str):
        stack = self._actor_stack.ids
        stack.append(actor_id)
        try:
            yield
        finally:
            stack.pop()

    def remote(self, cls_or_fn):
        if isinstance(cls_or_fn, type):
            return ActorClass(self, cls_or_fn)
        if callable(cls_or_fn):
            return RemoteFunction(cls_or_fn)
        raise TypeError("remote() takes a class or a function")

    @staticmethod
    def get(refs, *, timeout: Optional[float] = None):
        if isinstance(refs, ObjectRef):
            if refs._error is not None:
                raise refs._error
            return refs._value
        if isinstance(refs, (list, tuple)):
            return [LocalRuntime.get(r) for r in refs]
        raise TypeError(f"get() takes an ObjectRef or a list of them, not "
                        f"{type(refs).__name__}")

    @staticmethod
    def put(value: Any) -> ObjectRef:
        return ObjectRef(copy.deepcopy(value))

    @staticmethod
    def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None, fetch_local: bool = True
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        """Every ref is ready: the first ``num_returns`` in input order."""
        if isinstance(refs, ObjectRef):
            raise TypeError("wait() expects a list of ObjectRefs")
        refs = list(refs)
        if num_returns > len(refs):
            raise ValueError("num_returns exceeds the number of refs")
        if len({id(r) for r in refs}) != len(refs):
            raise ValueError("wait() got duplicate ObjectRefs")
        return refs[:num_returns], refs[num_returns:]

    def kill(self, actor: ActorHandle, *, no_restart: bool = True) -> None:
        if not isinstance(actor, ActorHandle):
            raise TypeError("kill() expects an actor handle")
        actor._instance = None
        actor._error = ActorDiedError(f"actor {actor._actor_id} was killed")
        for name in [n for n, h in self._named.items() if h is actor]:
            del self._named[name]

    def get_actor(self, name: str,
                  namespace: Optional[str] = None) -> ActorHandle:
        try:
            return self._named[name]
        except KeyError:
            raise ValueError(
                f"Failed to look up actor with name '{name}'") from None

    def get_runtime_context(self) -> RuntimeContext:
        stack = self._actor_stack.ids
        return RuntimeContext(stack[-1] if stack else None)


# -------------------------------------------------------------------- serve

_DEFAULT_HTTP_PORT = 8000   # ray_tpu.serve's default; nothing listens here


def _max_migrations() -> int:
    from ray_tpu_torch._private.config import config

    return max(0, int(config.serve_request_max_migrations))


def _note_migration(deployment: str) -> None:
    from ray_tpu_torch.serve.migration import note_migration

    note_migration(deployment)


def _engine_failed(err: BaseException) -> bool:
    from ray_tpu_torch.exceptions import EngineFailedError

    return isinstance(err, EngineFailedError)


def _exhausted(what: str, migrations: int, limit: int):
    from ray_tpu_torch.exceptions import RequestMigrationExhaustedError

    return RequestMigrationExhaustedError(
        f"{what} still failing after {migrations} migrations "
        f"(serve_request_max_migrations={limit})", migrations=migrations)


@dataclasses.dataclass
class Application:
    """A deployment bound to its constructor's arguments."""

    deployment: "Deployment"
    init_args: Tuple
    init_kwargs: Dict


class Deployment:
    def __init__(self, target: Callable, config: Dict[str, Any]):
        self._target = target
        self._config = config

    @property
    def name(self) -> str:
        return self._config["name"]

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


class _Replica:
    __slots__ = ("actor_id", "instance")

    def __init__(self, actor_id: str, instance: Any):
        self.actor_id = actor_id
        self.instance = instance


class DeploymentResponse:
    """The outcome of one handle call, made when ``.remote`` was called;
    ``result`` returns it or raises its error."""

    def __init__(self, call: Callable[[], Tuple[Any, Optional[BaseException]]],
                 deployment: str):
        self._call = call
        self._deployment = deployment
        self._value, self._error = call()

    def result(self, timeout: Optional[float] = None):
        limit, migrations = _max_migrations(), 0
        while self._error is not None:
            if not _engine_failed(self._error):
                raise self._error
            if migrations >= limit:
                raise _exhausted("request", migrations, limit) \
                    from self._error
            migrations += 1
            self._value, self._error = self._call()
            _note_migration(self._deployment)
        return self._value


class DeploymentResponseGenerator:
    """A stream: the replica's iterator, pulled in the caller's thread,
    each item handed over as a copy."""

    def __init__(self, handle: "DeploymentHandle", method: str, args,
                 kwargs, resume=None):
        self._handle = handle
        self._resume = resume
        self._delivered: List[Any] = []
        self._migrations = 0
        self._done = False
        self._replica, self._it = handle._open(method, args, kwargs)

    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._done:
                raise StopIteration
            try:
                with self._handle._serve._runtime._in_actor(
                        self._replica.actor_id):
                    item = next(self._it)
            except StopIteration:
                self._done = True
                raise
            except BaseException as e:
                if _engine_failed(e) and self._migrate(e):
                    continue
                self.cancel()
                raise
            item = copy.deepcopy(item)
            self._delivered.append(item)
            return item

    def _migrate(self, err: BaseException) -> bool:
        """Re-open on a replica from the items already delivered."""
        if self._resume is None:
            return False
        limit = _max_migrations()
        if self._migrations >= limit:
            self.cancel()
            raise _exhausted("stream", self._migrations, limit) from err
        call = self._resume(list(self._delivered))
        if call is None:
            return False
        method, args, kwargs = call
        self._replica, self._it = self._handle._open(method, args, kwargs)
        self._migrations += 1
        _note_migration(self._handle.deployment_name)
        return True

    def cancel(self):
        """Abandon the stream: the replica's iterator is closed."""
        if self._done:
            return
        self._done = True
        close = getattr(self._it, "close", None)
        if close is not None:
            close()

    close = cancel


class DeploymentHandle:
    """Calls into one deployment's replicas (module docstring)."""

    def __init__(self, serve: "Serve", deployment_name: str,
                 method_name: str = "__call__"):
        self._serve = serve
        self.deployment_name = deployment_name
        self._method = method_name

    def __deepcopy__(self, memo):
        return self

    def __getattr__(self, name: str) -> "_MethodCaller":
        if name.startswith("_"):
            raise AttributeError(name)
        return _MethodCaller(self, name)

    def _call(self, method: str, args, kwargs):
        replica = self._serve._pick(self.deployment_name)
        with self._serve._runtime._in_actor(replica.actor_id):
            ref = _run(getattr(replica.instance, method), args, kwargs)
        return ref._value, ref._error

    def _open(self, method: str, args, kwargs):
        replica = self._serve._pick(self.deployment_name)
        args, kwargs = copy.deepcopy((args, kwargs))
        with self._serve._runtime._in_actor(replica.actor_id):
            it = getattr(replica.instance, method)(*args, **kwargs)
        if not hasattr(it, "__next__"):
            raise TypeError(f"{self.deployment_name}.{method} returned "
                            f"{type(it).__name__}, not an iterator")
        return replica, it

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        return _MethodCaller(self, self._method).remote(*args, **kwargs)

    def remote_gen(self, *args, _item_timeout_s: Optional[float] = None,
                   _resume=None, **kwargs) -> DeploymentResponseGenerator:
        return _MethodCaller(self, self._method).remote_gen(
            *args, _item_timeout_s=_item_timeout_s, _resume=_resume,
            **kwargs)


class _MethodCaller:
    def __init__(self, handle: DeploymentHandle, method: str):
        self._handle = handle
        self._method = method

    def remote(self, *args, **kwargs) -> DeploymentResponse:
        h, method = self._handle, self._method
        return DeploymentResponse(lambda: h._call(method, args, kwargs),
                                  h.deployment_name)

    def remote_gen(self, *args, _item_timeout_s: Optional[float] = None,
                   _resume=None, **kwargs) -> DeploymentResponseGenerator:
        """``_item_timeout_s`` is taken and ignored: an item is pulled in
        the caller's own thread."""
        return DeploymentResponseGenerator(self._handle, self._method, args,
                                           kwargs, _resume)


class Serve:
    """``LocalRuntime.serve``: deployments as local replica objects."""

    def __init__(self, runtime: LocalRuntime):
        self._runtime = runtime
        self._lock = threading.Lock()
        self._replicas: Dict[str, List[_Replica]] = {}
        self._next: Dict[str, Any] = {}

    def __deepcopy__(self, memo):
        return self

    def deployment(self, target: Optional[Callable] = None, *,
                   name: Optional[str] = None,
                   num_replicas: int = 1,
                   max_ongoing_requests: int = 100,
                   route_prefix: Optional[str] = None,
                   autoscaling_config=None,
                   ray_actor_options: Optional[Dict[str, Any]] = None,
                   user_config: Any = None):
        """``deployment(cls, name=...)``, or a decorator without ``cls``."""

        def wrap(t: Callable) -> Deployment:
            return Deployment(t, {
                "name": name or t.__name__,
                "num_replicas": num_replicas,
                "max_ongoing_requests": max_ongoing_requests,
                "route_prefix": route_prefix,
                "autoscaling_config": autoscaling_config,
                "ray_actor_options": dict(ray_actor_options or {}),
                "user_config": user_config,
            })

        return wrap if target is None else wrap(target)

    def _resolve(self, v):
        if isinstance(v, Application):
            return self.run(v)
        if isinstance(v, (list, tuple)):
            return type(v)(self._resolve(x) for x in v)
        if isinstance(v, dict):
            return {k: self._resolve(x) for k, x in v.items()}
        return v

    def run(self, app: Application, *, name: Optional[str] = None,
            route_prefix: Optional[str] = None,
            http_port: Optional[int] = _DEFAULT_HTTP_PORT,
            _blocking: bool = False) -> DeploymentHandle:
        """Deploy ``app`` (bound children first, each replaced by its
        handle) and return its handle. A deployment of the same name is
        replaced."""
        args = self._resolve(app.init_args)
        kwargs = self._resolve(app.init_kwargs)
        dep = app.deployment
        name = name or dep.name
        rt = self._runtime
        replicas = []
        for _ in range(max(1, int(dep._config["num_replicas"]))):
            actor_id = f"{name}-{next(rt._ids)}"
            a, kw = copy.deepcopy((args, kwargs))
            with rt._in_actor(actor_id):
                replicas.append(_Replica(actor_id, dep._target(*a, **kw)))
        with self._lock:
            self._replicas[name] = replicas
            self._next[name] = itertools.count()
        return DeploymentHandle(self, name)

    def delete(self, name: str) -> None:
        """Drop the deployment's replicas (a replica's ``__del__`` then
        runs, as at the end of a replica process)."""
        with self._lock:
            self._replicas.pop(name, None)
            self._next.pop(name, None)

    def get_deployment_handle(self, deployment_name: str
                              ) -> DeploymentHandle:
        return DeploymentHandle(self, deployment_name)

    def _pick(self, name: str) -> _Replica:
        with self._lock:
            replicas = self._replicas.get(name)
            if not replicas:
                raise RuntimeError(f"no replicas for deployment {name!r}")
            return replicas[next(self._next[name]) % len(replicas)]
