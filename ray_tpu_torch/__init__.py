"""PyTorch/CUDA port of ray_tpu's model path, for one NVIDIA Hopper GPU.

The JAX package ``ray_tpu`` is the reference; module names here mirror it
(``ops.attention``, ``ops.flash_attention``, ``models.transformer``,
``models.generate``, ``serve.llm``, ``rllib``, ``parallel.collective``,
``train``) so each counterpart is easy to find; ``random`` repeats the threefry ``jax.random`` the serving path
and the RL policies sample with. This package imports ``torch`` and numpy,
never ``jax`` or ``optax`` and nothing of ``ray_tpu``. Its kernels are
CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use
(``ops/_kernels.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU they raise rather than drift to the CPU.
"""

from ray_tpu_torch.device import resolve_device  # noqa: F401

__all__ = ["resolve_device"]
