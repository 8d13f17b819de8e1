"""Attention ops: the reference MHA (``attention``) and the flash-attention
kernels (``flash_attention``)."""

from ray_tpu_torch.ops.attention import mha_reference  # noqa: F401

__all__ = ["mha_reference"]
