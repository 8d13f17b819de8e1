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
"""

from __future__ import annotations

import contextlib
import copy
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# options() takes these and ignores them: one process has no resources to
# reserve.
_RESOURCE_OPTIONS = frozenset({"num_cpus", "num_gpus", "num_tpus"})


class ActorDiedError(RuntimeError):
    """A method was called on an actor that was killed."""


class ObjectRef:
    """A resolved result: the value, or the exception the call raised."""

    __slots__ = ("_value", "_error")

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


class LocalRuntime:
    """The runtime seam's calls in one process (module docstring)."""

    def __init__(self):
        self._named: Dict[str, ActorHandle] = {}
        self._ids = itertools.count()
        self._actor_stack: List[str] = []

    def __deepcopy__(self, memo):
        return self

    @contextlib.contextmanager
    def _in_actor(self, actor_id: str):
        self._actor_stack.append(actor_id)
        try:
            yield
        finally:
            self._actor_stack.pop()

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
        return RuntimeContext(self._actor_stack[-1] if self._actor_stack
                              else None)
