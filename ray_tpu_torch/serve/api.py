"""Serve public API on the port's runtime (a copy of
``ray_tpu/serve/api.py``; reference: ``serve/api.py`` — ``serve.run``
:458, ``@serve.deployment``, ``serve.start``). The deployment's callable
travels to the controller and its replicas through
``_private/pickler.py``."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

from ray_tpu_torch._private import pickler
from ray_tpu_torch.serve.config import AutoscalingConfig, DeploymentConfig
from ray_tpu_torch.serve.controller import CONTROLLER_NAME, ServeController
from ray_tpu_torch.serve.handle import DeploymentHandle

_DEFAULT_HTTP_PORT = 8000


@dataclasses.dataclass
class Application:
    """A deployment bound to its init args (reference: ``Application`` from
    ``Deployment.bind`` — the deployment-graph build collapsed to the
    single-node case; multi-deployment graphs compose via handles)."""

    deployment: "Deployment"
    init_args: Tuple
    init_kwargs: Dict


class Deployment:
    def __init__(self, target: Callable, config: DeploymentConfig):
        self._target = target
        self._config = config

    @property
    def name(self) -> str:
        return self._config.name

    def options(self, **overrides) -> "Deployment":
        cfg = dataclasses.replace(self._config)
        for k, v in overrides.items():
            if not hasattr(cfg, k):
                raise ValueError(f"unknown deployment option {k!r}")
            setattr(cfg, k, v)
        return Deployment(self._target, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)


def deployment(target: Optional[Callable] = None, *,
               name: Optional[str] = None,
               num_replicas: int = 1,
               max_ongoing_requests: int = 100,
               route_prefix: Optional[str] = None,
               autoscaling_config: Optional[AutoscalingConfig] = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               user_config: Any = None):
    """``@serve.deployment`` decorator (reference: serve/api.py)."""

    def wrap(t: Callable) -> Deployment:
        cfg = DeploymentConfig(
            name=name or t.__name__,
            num_replicas=num_replicas,
            max_ongoing_requests=max_ongoing_requests,
            route_prefix=route_prefix,
            autoscaling_config=autoscaling_config,
            ray_actor_options=ray_actor_options or {},
            user_config=user_config,
        )
        return Deployment(t, cfg)

    if target is not None:
        return wrap(target)
    return wrap


# ----------------------------------------------------------------- control


def start(http_port: Optional[int] = _DEFAULT_HTTP_PORT,
          detached: bool = True) -> None:
    """Start the Serve control plane: named controller actor (+ HTTP proxy)."""
    import ray_tpu_torch
    from ray_tpu_torch._private.config import config

    try:
        ray_tpu_torch.get_actor(CONTROLLER_NAME)
        return
    except Exception:
        pass
    ctrl_cls = ray_tpu_torch.remote(ServeController)
    # Threaded actor: parked listen_for_change long-polls (one per live
    # handle/proxy) must not serialize control calls.
    # The driver's non-default config (init's _system_config + any
    # programmatic set()) rides along and is re-applied in the
    # controller AND each proxy actor's process — worker processes do
    # not inherit the driver's registry, and the ingress admission
    # knobs (serve_ingress_*) are read proxy-side.
    ctrl = ctrl_cls.options(
        name=CONTROLLER_NAME,
        max_concurrency=64,
        lifetime="detached" if detached else None).remote(
        http_port=http_port, system_config=config.diff_nondefault())
    import time
    deadline = time.time() + 30
    while time.time() < deadline:
        try:
            ray_tpu_torch.get(ctrl.list_deployments.remote(), timeout=5)
            return
        except Exception:
            time.sleep(0.1)
    raise RuntimeError("serve controller failed to start")


def _controller():
    import ray_tpu_torch

    return ray_tpu_torch.get_actor(CONTROLLER_NAME)


def _deploy_children(args, kwargs, http_port):
    """Deployment-graph build (reference:
    ``serve/_private/deployment_graph_build.py`` — a bound node's args may
    contain OTHER bound nodes; children deploy first, and the parent's
    constructor receives their DeploymentHandles). Collapsed here to the
    essential recursion: Application-in-args -> deploy -> handle."""
    def resolve(v):
        if isinstance(v, Application):
            return run(v, http_port=http_port)
        if isinstance(v, (list, tuple)):
            return type(v)(resolve(x) for x in v)
        if isinstance(v, dict):
            return {k: resolve(x) for k, x in v.items()}
        return v

    return (tuple(resolve(a) for a in args),
            {k: resolve(v) for k, v in kwargs.items()})


def run(app: Application, *, name: Optional[str] = None,
        route_prefix: Optional[str] = None,
        http_port: Optional[int] = _DEFAULT_HTTP_PORT,
        _blocking: bool = False) -> DeploymentHandle:
    """Deploy an application — including multi-deployment graphs built by
    nesting ``.bind()`` results — and return the root handle (reference:
    serve.run ``serve/api.py:458`` + deployment_graph_build.py)."""
    import ray_tpu_torch

    start(http_port=http_port)
    init_args, init_kwargs = _deploy_children(app.init_args,
                                              app.init_kwargs, http_port)
    app = Application(app.deployment, init_args, init_kwargs)
    dep = app.deployment
    cfg = dep._config
    if route_prefix is not None:
        cfg = dataclasses.replace(cfg, route_prefix=route_prefix)
    elif cfg.route_prefix is None:
        cfg = dataclasses.replace(cfg, route_prefix=f"/{cfg.name}")
    if name:
        cfg = dataclasses.replace(cfg, name=name)

    config_dict = {
        "name": cfg.name,
        "num_replicas": cfg.num_replicas,
        "max_ongoing_requests": cfg.max_ongoing_requests,
        "route_prefix": cfg.route_prefix,
        "autoscaling_config": dataclasses.asdict(cfg.autoscaling_config)
        if cfg.autoscaling_config else None,
        "ray_actor_options": cfg.ray_actor_options,
        "user_config": cfg.user_config,
    }
    blob = pickler.dumps(dep._target)
    ray_tpu_torch.get(_controller().deploy.remote(
        config_dict, blob, app.init_args, app.init_kwargs))
    # Wait for at least one replica.
    handle = DeploymentHandle(cfg.name)
    handle._pick()
    return handle


def get_deployment_handle(deployment_name: str) -> DeploymentHandle:
    return DeploymentHandle(deployment_name)


def get_app_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str) -> None:
    import ray_tpu_torch

    ray_tpu_torch.get(_controller().delete_deployment.remote(name))


def status() -> Dict[str, dict]:
    import ray_tpu_torch

    try:
        return ray_tpu_torch.get(_controller().list_deployments.remote())
    except Exception:
        return {}


def shutdown() -> None:
    import ray_tpu_torch

    try:
        ctrl = _controller()
    except Exception:
        return
    try:
        ray_tpu_torch.get(ctrl.shutdown.remote(), timeout=10)
    except Exception:
        pass
    try:
        ray_tpu_torch.kill(ctrl)
    except Exception:
        pass
