"""Serving of the port (the counterpart of ``ray_tpu.serve``).

The control plane runs on the port's own runtime: a controller actor that
reconciles replica actors toward each deployment's target, autoscales
them on queue depth and learns of their deaths from the GCS's
``actor_state`` pubsub; handles that route on the loads the controller
pushes; and an HTTP/SSE ingress on the standard library's ``asyncio``
with tenant admission (``serve.ingress``). A deployment's replicas may
hold GPUs (``ray_actor_options={"num_gpus": 1}``); the controller and the
proxies take none.

With ``runtime=ray_tpu_torch`` this package is ``runtime.serve`` for the
LLM tier (``serve.llm``: engine, replicas, router, KV handoff, and
``build_llm_app``), as ``ray_tpu.serve`` is on the JAX package's runtime.
``serve.migration`` is the client-side request migration the handles
ride. The LLM tier's names load on first use, so a controller or proxy
process does not import the model stack.
"""

from ray_tpu_torch.serve.api import (  # noqa: F401
    Application,
    Deployment,
    deployment,
    delete,
    get_app_handle,
    get_deployment_handle,
    run,
    shutdown,
    start,
    status,
)
from ray_tpu_torch.serve.config import AutoscalingConfig  # noqa: F401
from ray_tpu_torch.serve.handle import (  # noqa: F401
    DeploymentHandle,
    DeploymentResponse,
    DeploymentResponseGenerator,
)
from ray_tpu_torch.serve import migration  # noqa: F401

_LLM_NAMES = ("EngineConfig", "InflightBatchEngine", "BlockPool",
              "LLMReplica", "PrefillReplica", "DecodeReplica", "LLMRouter",
              "build_llm_app")

__all__ = [
    "Application", "Deployment", "deployment", "delete", "get_app_handle",
    "get_deployment_handle", "run", "shutdown", "start", "status",
    "AutoscalingConfig", "DeploymentHandle", "DeploymentResponse",
    "DeploymentResponseGenerator", *_LLM_NAMES,
]


def __getattr__(name):
    if name in _LLM_NAMES:
        from ray_tpu_torch.serve import llm

        return getattr(llm, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


from ray_tpu_torch._private import usage as _usage  # noqa: E402

_usage.record_library_usage("serve")
del _usage
