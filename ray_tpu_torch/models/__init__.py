"""Models of the port: the GPT-2-family decoder (``transformer``).

The same public names as ``ray_tpu.models`` minus ``param_logical_axes``
(mesh sharding is not ported yet) and the MLP family.
"""

from ray_tpu_torch.models.transformer import (  # noqa: F401
    GPTConfig,
    init_params,
    forward,
    loss_fn,
    TrainState,
    make_train_state,
    make_train_step,
    count_params,
)
from ray_tpu_torch.models.convert import params_from_numpy  # noqa: F401

__all__ = [
    "GPTConfig", "init_params", "forward", "loss_fn", "TrainState",
    "make_train_state", "make_train_step", "count_params",
    "params_from_numpy",
]
