"""Reinforcement learning (port of ``ray_tpu/rllib``), with torch in place
of jax and optax.

Ported: the sample batch and GAE, connectors, the MLP policy, V-trace, the
shared ``Learner`` and ``Algorithm``, ``LearnerGroup``, the PPO, A2C,
IMPALA, BC, DQN, Ape-X and SAC learners and algorithms, multi-agent PPO,
DD-PPO (on ``parallel.collective``), the rollout workers and the offline
JSON IO; ``convert`` carries the
reference's state over. Algorithms drive their rollout actors through a
runtime (``ray_tpu_torch.runtime.LocalRuntime`` unless one is given, such
as the ``ray_tpu`` module); learners and workers take ``device`` (default
``cuda``); env stepping and replay stay numpy on the host.
"""

from ray_tpu_torch.rllib.a2c import A2C, A2CConfig, A2CLearner  # noqa: F401
from ray_tpu_torch.rllib.algorithm import (  # noqa: F401
    Algorithm, AlgorithmConfig, Learner,
)
from ray_tpu_torch.rllib.apex import (  # noqa: F401
    ApexDQN, ApexDQNConfig, ApexDQNLearner,
)
from ray_tpu_torch.rllib.connectors import (  # noqa: F401
    ClipAction, ClipObs, Connector, ConnectorPipeline, FlattenObs,
    MeanStdFilter,
)
from ray_tpu_torch.rllib.ddppo import DDPPO, DDPPOConfig  # noqa: F401
from ray_tpu_torch.rllib.dqn import (  # noqa: F401
    DQN, DQNConfig, DQNLearner, ReplayBuffer,
)
from ray_tpu_torch.rllib.impala import (  # noqa: F401
    IMPALA, IMPALAConfig, IMPALALearner,
)
from ray_tpu_torch.rllib.learner_group import LearnerGroup  # noqa: F401
from ray_tpu_torch.rllib.multi_agent import (  # noqa: F401
    MultiAgentPPO, MultiAgentPPOConfig,
)
from ray_tpu_torch.rllib.offline import (  # noqa: F401
    BC, BCConfig, BCLearner, JsonReader, JsonWriter,
)
from ray_tpu_torch.rllib.policy import MLPPolicy, PolicySpec  # noqa: F401
from ray_tpu_torch.rllib.ppo import PPO, PPOConfig, PPOLearner  # noqa: F401
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker  # noqa: F401
from ray_tpu_torch.rllib.sac import (  # noqa: F401
    SAC, ContinuousPolicySpec, ContinuousReplayBuffer, GaussianPolicy,
    SACConfig, SACLearner,
)
from ray_tpu_torch.rllib.sample_batch import (  # noqa: F401
    SampleBatch, concat_batches,
)

__all__ = [
    "SampleBatch", "concat_batches", "MLPPolicy", "PolicySpec",
    "RolloutWorker", "Algorithm", "AlgorithmConfig", "Learner",
    "LearnerGroup", "PPO", "PPOConfig", "PPOLearner", "A2C", "A2CConfig",
    "A2CLearner", "IMPALA", "IMPALAConfig", "IMPALALearner", "BC",
    "BCConfig", "BCLearner", "JsonReader", "JsonWriter", "DQN", "DQNConfig",
    "DQNLearner", "ReplayBuffer", "ApexDQN", "ApexDQNConfig",
    "ApexDQNLearner", "ContinuousPolicySpec", "ContinuousReplayBuffer",
    "GaussianPolicy", "SAC", "SACConfig", "SACLearner", "MultiAgentPPO",
    "MultiAgentPPOConfig", "ClipAction", "ClipObs", "Connector",
    "ConnectorPipeline", "FlattenObs", "MeanStdFilter", "DDPPO",
    "DDPPOConfig",
]
