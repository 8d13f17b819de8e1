"""The ``@ray_tpu_torch.remote`` decorator (reference: python/ray/__init__.py
``remote`` → remote_function.py:35 / actor.py:377)."""

from __future__ import annotations

import inspect

from ray_tpu_torch.actor import ActorClass, method  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction


def _make_remote(obj, options):
    if inspect.isclass(obj):
        return ActorClass(obj, options)
    if callable(obj):
        return RemoteFunction(obj, options)
    raise TypeError(
        "@ray_tpu_torch.remote decorates functions or classes, got "
        f"{type(obj).__name__}")


def remote(*args, **kwargs):
    if len(args) == 1 and not kwargs and (inspect.isclass(args[0])
                                          or callable(args[0])):
        return _make_remote(args[0], {})
    if args:
        raise TypeError("@ray_tpu_torch.remote() takes keyword options only")

    def decorator(obj):
        return _make_remote(obj, dict(kwargs))

    return decorator
