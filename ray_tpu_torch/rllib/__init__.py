"""Reinforcement learning (port of ``ray_tpu/rllib``): the numeric core that
runs in-process, with torch in place of jax and optax.

Ported: the sample batch and GAE, connectors, the MLP policy, V-trace, the
shared ``Learner``, the PPO, A2C, IMPALA, BC, DQN, Ape-X (weighted update and
prioritized shard) and SAC learners, the rollout workers (on-policy, DQN,
Ape-X, SAC, multi-agent) and the offline JSON IO; ``convert`` carries the
reference's state over. Learners and workers take ``device`` (default
``cuda``); env stepping and replay stay numpy on the host.

Waiting for the port's runtime seam: ``Algorithm`` (``setup``,
``training_step``, checkpoints, ``as_trainable``), ``LearnerGroup`` and
DD-PPO, which drive actors through ``remote`` / ``get`` / ``wait``.
"""

from ray_tpu_torch.rllib.a2c import A2CConfig, A2CLearner  # noqa: F401
from ray_tpu_torch.rllib.algorithm import (  # noqa: F401
    AlgorithmConfig, Learner,
)
from ray_tpu_torch.rllib.apex import (  # noqa: F401
    ApexDQNConfig, ApexDQNLearner,
)
from ray_tpu_torch.rllib.connectors import (  # noqa: F401
    ClipAction, ClipObs, Connector, ConnectorPipeline, FlattenObs,
    MeanStdFilter,
)
from ray_tpu_torch.rllib.dqn import (  # noqa: F401
    DQNConfig, DQNLearner, ReplayBuffer,
)
from ray_tpu_torch.rllib.impala import (  # noqa: F401
    IMPALAConfig, IMPALALearner,
)
from ray_tpu_torch.rllib.multi_agent import MultiAgentPPOConfig  # noqa: F401
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    BCConfig, BCLearner, JsonReader, JsonWriter,
)
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec  # noqa: F401
from ray_tpu_torch.rllib.ppo import PPOConfig, PPOLearner  # noqa: F401
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rllib.sac import (  # noqa: F401
    ContinuousPolicySpec, ContinuousReplayBuffer, GaussianPolicy, SACConfig,
    SACLearner,
)
from ray_tpu_torch.rllib.sample_batch import (  # noqa: F401
    SampleBatch, concat_batches,
)

__all__ = [
    "SampleBatch", "concat_batches", "MLPPolicy", "PolicySpec",
    "RolloutWorker", "AlgorithmConfig", "Learner",
    "PPOConfig", "PPOLearner", "A2CConfig", "A2CLearner",
    "IMPALAConfig", "IMPALALearner", "BCConfig", "BCLearner",
    "JsonReader", "JsonWriter", "DQNConfig", "DQNLearner", "ReplayBuffer",
    "ApexDQNConfig", "ApexDQNLearner", "ContinuousPolicySpec",
    "ContinuousReplayBuffer", "GaussianPolicy", "SACConfig", "SACLearner",
    "MultiAgentPPOConfig", "ClipAction", "ClipObs", "Connector",
    "ConnectorPipeline", "FlattenObs", "MeanStdFilter",
]
