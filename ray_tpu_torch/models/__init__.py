"""Models of the port: the GPT-2-family decoder (``transformer``), its
KV-cache generation (``generate``) and the small dense nets (``mlp``).

The same public names as ``ray_tpu.models``, plus ``shard_params`` (params
laid out on a mesh by ``param_logical_axes``), the numpy converters, the KV-cache
functions of ``generate`` and ``serving_params`` (the block weights cast to
the compute dtype once). ``generate`` itself is the submodule's name, so
the function stays ``models.generate.generate``.
"""

from ray_tpu_torch.models.transformer import (  # noqa: F401
    GPTConfig,
    init_params,
    param_logical_axes,
    shard_params,
    new_train_state,
    forward,
    loss_fn,
    TrainState,
    make_train_state,
    make_train_step,
    count_params,
)
from ray_tpu_torch.models.mlp import (  # noqa: F401
    MLPConfig,
    mlp_init,
    mlp_forward,
    mlp_params_from_numpy,
)
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: F401
from ray_tpu_torch.models.generate import (  # noqa: F401
    adopt_slot,
    adopt_slot_paged,
    decode_step,
    decode_step_paged,
    init_cache,
    init_paged_pool,
    init_slotted_cache,
    prefill,
    prefill_chunk_paged,
    prefill_slot,
    prefill_slots,
    serving_params,
)

__all__ = [
    "GPTConfig", "init_params", "param_logical_axes", "shard_params",
    "new_train_state",
    "forward", "loss_fn", "TrainState",
    "make_train_state", "make_train_step", "count_params",
    "MLPConfig", "mlp_init", "mlp_forward", "mlp_params_from_numpy",
    "params_from_numpy", "init_cache", "prefill",
    "init_slotted_cache", "prefill_slot", "adopt_slot", "decode_step",
    "init_paged_pool", "decode_step_paged", "prefill_chunk_paged",
    "adopt_slot_paged", "prefill_slots", "serving_params",
]
