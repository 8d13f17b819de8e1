"""PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper GPUs.

The JAX package ``ray_tpu`` is the reference; module names here mirror it
(``ops.attention``, ``ops.flash_attention``, ``models.transformer``,
``models.generate``, ``serve.llm``, ``rllib``, ``parallel.collective``,
``train``) so each counterpart is easy to find; ``random`` repeats the
threefry ``jax.random`` the serving path and the RL policies sample with.
This package uses ``torch`` and numpy, never ``jax``, ``optax`` or
``cloudpickle`` and nothing of ``ray_tpu``. Its kernels are CUDA C++ for
``sm_90a`` under ``csrc/``, built at first use (``ops/_kernels.py``).

The runtime core is the port's own copy of the reference's: tasks, actors,
``put/get/wait``, the shared-memory object store, the GCS and the node
manager, with GPUs scheduled as whole devices where the reference has TPU
chips (each GPU worker gets its ``CUDA_VISIBLE_DEVICES``). Its public calls
are exported here, so the module itself serves as a runtime for the
modules that take one (``runtime=ray_tpu_torch``); the in-process
``runtime.LocalRuntime`` stays their default. ``ray_tpu_torch.serve`` is
its serve control plane (controller, replica actors, handles, an HTTP/SSE
ingress), and so ``runtime.serve`` for the LLM tier.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than drift to the CPU.

``import ray_tpu_torch`` loads no torch: the control plane (the GCS, the
node manager, the CLI, the dashboard head, the lint) runs without it, as
the reference's runs without jax. ``resolve_device`` is resolved on first
access, and a process that imports torch afterwards still moves its
tensors out of band (``_private/device_objects.py``).
"""

from ray_tpu_torch.version import __version__  # noqa: F401
from ray_tpu_torch import exceptions  # noqa: F401

# Runtime lock-order witness (RAY_TPU_TORCH_LOCKDEP_ENABLED): it must
# install BEFORE any ray_tpu_torch module creates its locks, so it rides
# the very first import.
from ray_tpu_torch._private import lockdep as _lockdep

_lockdep.maybe_install()

from ray_tpu_torch.api import (  # noqa: E402,F401
    init,
    shutdown,
    is_initialized,
    remote,
    get,
    put,
    wait,
    cancel,
    kill,
    get_actor,
    method,
    ObjectRef,
    ObjectRefGenerator,
    get_runtime_context,
    available_resources,
    cluster_resources,
    nodes,
    timeline,
)

# The node manager hands each GPU worker its own CUDA_VISIBLE_DEVICES:
# modules that pin a rank's GPU themselves leave it to this runtime.
ASSIGNS_GPUS = True

__all__ = [
    "init", "shutdown", "is_initialized", "remote", "get", "put", "wait",
    "cancel", "kill", "get_actor", "method", "ObjectRef",
    "ObjectRefGenerator",
    "get_runtime_context", "available_resources", "cluster_resources",
    "nodes", "timeline", "exceptions", "resolve_device", "ASSIGNS_GPUS",
    "__version__",
]


def __getattr__(name):
    # ``resolve_device`` imports torch: resolved on first use, so that the
    # package itself does not.
    if name == "resolve_device":
        from ray_tpu_torch.device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
