"""Offline RL: experience IO and behavior cloning (port of
``ray_tpu/rllib/offline.py``).

``JsonWriter`` and ``JsonReader`` are the port's own copies of the
reference's plain-Python JSONL shards (one JSON object per SampleBatch,
columns as lists). ``BCLearner`` maximizes the log-likelihood of dataset
actions; ``BC`` trains it from the dataset alone, with no rollout actors,
and ``evaluate`` rolls the greedy policy out on ``device``.
"""

from __future__ import annotations

import dataclasses
import glob as glob_mod
import json
import os
from typing import Any, Dict, Iterator

import numpy as np
import torch

from ray_tpu_torch.device import DeviceLike
from ray_tpu_torch.rllib.algorithm import Algorithm, AlgorithmConfig, Learner
from ray_tpu_torch.rllib.policy import PolicySpec
from ray_tpu_torch.rllib.ppo import logp_of
from ray_tpu_torch.rllib.sample_batch import (
    ACTIONS, OBS, SampleBatch, concat_batches,
)


class JsonWriter:
    """Append SampleBatches to JSONL shards (reference: json_writer.py)."""

    def __init__(self, path: str, max_shard_bytes: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._shard_idx = 0
        self._bytes = 0
        self._max = max_shard_bytes
        self._f = None

    def _open(self):
        if self._f is None or self._bytes >= self._max:
            if self._f is not None:
                self._f.close()
                self._shard_idx += 1
                self._bytes = 0
            self._f = open(os.path.join(
                self.path, f"shard-{self._shard_idx:05d}.jsonl"), "a")
        return self._f

    def write(self, batch) -> None:
        row = {k: np.asarray(v).tolist() for k, v in dict(batch).items()}
        line = json.dumps(row) + "\n"
        f = self._open()
        f.write(line)
        f.flush()
        self._bytes += len(line)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None


class JsonReader:
    """Stream SampleBatches back from JSONL shards."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(glob_mod.glob(os.path.join(path,
                                                           "*.jsonl")))
        else:
            self.files = sorted(glob_mod.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no experience shards at {path!r}")

    def __iter__(self) -> Iterator[SampleBatch]:
        for fp in self.files:
            with open(fp) as f:
                for line in f:
                    if line.strip():
                        row = json.loads(line)
                        yield SampleBatch({k: np.asarray(v)
                                           for k, v in row.items()})

    def read_all(self) -> SampleBatch:
        return concat_batches(list(self))


@dataclasses.dataclass
class BCConfig(AlgorithmConfig):
    """Behavior cloning from a recorded dataset (reference:
    rllib/algorithms/bc). ``input_path``: JSONL experience shards."""

    input_path: str = ""
    lr: float = 1e-3
    train_batch_size: int = 256
    sgd_iters_per_step: int = 32
    evaluation_episodes: int = 0   # >0: greedy rollouts each train()


class BCLearner(Learner):
    def __init__(self, spec: PolicySpec, config: BCConfig, *,
                 device: DeviceLike = None):

        def loss_fn(policy, batch):
            logits, _ = policy(batch[OBS])
            nll = -logp_of(torch.log_softmax(logits, -1),
                           batch[ACTIONS]).mean()
            return nll, {"bc_loss": nll}

        super().__init__(spec, config, loss_fn, device=device)


class BC(Algorithm):
    """Dataset-only training (reference: ``offline.py:121-171``)."""

    def setup(self) -> None:
        config = self.config
        self.learner = BCLearner(self.spec, config, device=self.device)
        data = JsonReader(config.input_path).read_all()
        self._obs = np.asarray(data[OBS], np.float32)
        self._actions = np.asarray(data[ACTIONS], np.int32)

    def training_step(self) -> Dict[str, Any]:
        n = len(self._actions)
        bs = min(self.config.train_batch_size, n)
        metrics: Dict[str, Any] = {}
        for _ in range(self.config.sgd_iters_per_step):
            idx = self._np_rng.integers(0, n, bs)
            metrics = self.learner.step({
                OBS: self._obs[idx], ACTIONS: self._actions[idx]})
        out = {"timesteps_this_iter": bs
               * self.config.sgd_iters_per_step, **metrics}
        if self.config.evaluation_episodes:
            out["evaluation_return_mean"] = self.evaluate(
                self.config.evaluation_episodes)
        return out

    @torch.no_grad()
    def evaluate(self, episodes: int) -> float:
        """Greedy rollouts of the cloned policy (offline evaluation), the
        policy on the learner's device."""
        env = self.config.env_creator()
        policy, device = self.learner.policy, self.learner.device
        returns = []
        for ep in range(episodes):
            obs, _ = env.reset(seed=1000 + ep)
            done, total = False, 0.0
            while not done:
                logits, _ = policy(torch.as_tensor(
                    np.asarray(obs, np.float32)[None], device=device))
                a = int(torch.argmax(logits[0]))
                obs, r, term, trunc, _ = env.step(a)
                total += float(r)
                done = term or trunc
            returns.append(total)
        close = getattr(env, "close", None)
        if close:
            close()
        return float(np.mean(returns))


BCConfig._algo_cls = BC
