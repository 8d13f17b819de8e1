"""Connectors: the port's own copy of ``ray_tpu/rllib/connectors.py``
(numpy, unchanged). Composable observation/action transforms between the
env and the policy (reference: ``rllib/connectors/`` — ConnectorV2 pipelines;
``connectors/env_to_module/`` obs preprocessing like mean-std filtering
and frame flattening, ``connectors/module_to_env/`` action translation).

A ``ConnectorPipeline`` is a list of connectors applied in order. Obs
connectors run env->policy (each sees and returns an np.ndarray); action
connectors run policy->env. Stateful connectors (e.g. MeanStdFilter)
expose ``get_state``/``set_state`` so rollout workers can sync them with
the trainer (the reference syncs filter state through the algorithm).

Wire into rollout via ``RolloutWorker(..., connectors=pipeline)`` (the
worker applies ``transform_obs`` before every policy call and
``transform_action`` before every ``env.step``).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np


class Connector:
    """One transform stage. Override what applies; identity otherwise."""

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        return obs

    def transform_action(self, action: Any) -> Any:
        return action

    def get_state(self) -> Optional[dict]:
        return None

    def set_state(self, state: Optional[dict]) -> None:
        pass


class FlattenObs(Connector):
    """Flatten any obs shape to 1-D (reference:
    env_to_module/flatten_observations.py)."""

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        return np.asarray(obs, np.float32).ravel()


class ClipObs(Connector):
    """Clip observations elementwise (outlier guard)."""

    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = low, high

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        return np.clip(obs, self.low, self.high)


class MeanStdFilter(Connector):
    """Running mean/std observation normalization (reference:
    ``rllib/utils/filter.py`` MeanStdFilter via connectors). Uses
    Welford's online algorithm; state is syncable across workers."""

    def __init__(self, eps: float = 1e-8):
        self.eps = eps
        self._n = 0
        self._mean: Optional[np.ndarray] = None
        self._m2: Optional[np.ndarray] = None

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        obs = np.asarray(obs, np.float64)
        if self._mean is None:
            self._mean = np.zeros_like(obs)
            self._m2 = np.zeros_like(obs)
        self._n += 1
        delta = obs - self._mean
        self._mean = self._mean + delta / self._n
        self._m2 = self._m2 + delta * (obs - self._mean)
        if self._n < 2:
            return np.asarray(obs - self._mean, np.float32)
        std = np.sqrt(self._m2 / (self._n - 1)) + self.eps
        return np.asarray((obs - self._mean) / std, np.float32)

    def get_state(self) -> dict:
        return {"n": self._n,
                "mean": None if self._mean is None else self._mean.copy(),
                "m2": None if self._m2 is None else self._m2.copy()}

    def set_state(self, state: Optional[dict]) -> None:
        if not state:
            return
        self._n = state["n"]
        self._mean = state["mean"]
        self._m2 = state["m2"]


class ClipAction(Connector):
    """Clip continuous actions into the env's bounds (reference:
    module_to_env/...: unsquash/clip action translation)."""

    def __init__(self, low, high):
        self.low = np.asarray(low, np.float32)
        self.high = np.asarray(high, np.float32)

    def transform_action(self, action: Any) -> Any:
        return np.clip(np.asarray(action, np.float32), self.low, self.high)


class ConnectorPipeline(Connector):
    """Ordered composition of connectors."""

    def __init__(self, connectors: Sequence[Connector]):
        self.connectors: List[Connector] = list(connectors)

    def transform_obs(self, obs: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            obs = c.transform_obs(obs)
        return obs

    def transform_action(self, action: Any) -> Any:
        for c in self.connectors:
            action = c.transform_action(action)
        return action

    def get_state(self) -> Dict[int, Any]:
        return {i: c.get_state() for i, c in enumerate(self.connectors)}

    def set_state(self, state: Optional[dict]) -> None:
        for i, c in enumerate(self.connectors):
            if state and i in state:
                c.set_state(state[i])
