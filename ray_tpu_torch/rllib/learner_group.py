"""Data-parallel learner group (port of ``ray_tpu/rllib/learner_group.py``;
reference: ``rllib/core/learner/learner_group.py:51``).

Replication discipline: every learner actor starts from shard 0's weights,
so params and optimizer state are identical; each update shards the
minibatch, averages the ``{name: tensor}`` gradients at the driver, and
applies the SAME averaged gradient on every learner. The replicas stay
bit-identical without a parameter broadcast (the DDP invariant, kept by
construction). The shards are actors of ``runtime`` (a ``LocalRuntime``
when None); over the ``ray_tpu`` runtime their tensors cross processes on
the CPU.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np

from ray_tpu_torch.rllib.algorithm import Tensors
from ray_tpu_torch.runtime import LocalRuntime


class _LearnerShard:
    """Actor hosting one learner replica."""

    def __init__(self, learner_factory: Callable[[], Any]):
        self.learner = learner_factory()

    def compute_grads(self, batch):
        return self.learner.compute_grads(batch)

    def apply_grads(self, grads):
        self.learner.apply_grads(grads)
        return True

    def get_weights(self):
        return self.learner.get_weights()

    def set_weights(self, w):
        self.learner.set_weights(w)
        return True

    def get_state(self):
        return self.learner.get_state()

    def set_state(self, state):
        self.learner.set_state(state)
        return True


class LearnerGroup:
    """Drop-in for a single learner's ``update_from_batch`` surface."""

    def __init__(self, learner_factory: Callable[[], Any],
                 num_learners: int, *, runtime: Any = None):
        if num_learners < 1:
            raise ValueError("num_learners must be >= 1")
        self._rt = LocalRuntime() if runtime is None else runtime
        shard_cls = self._rt.remote(_LearnerShard)
        self._shards = [shard_cls.remote(learner_factory)
                        for _ in range(num_learners)]
        # Identical starting state even if the factory is stochastic.
        w0 = self._rt.get(self._shards[0].get_weights.remote())
        self._rt.get([s.set_weights.remote(w0) for s in self._shards[1:]])
        self._n = num_learners

    @staticmethod
    def _average(grads_list: List[Tensors], weights: List[int]) -> Tensors:
        """Example-count-weighted mean, summed in the reference's order:
        the full-batch gradient of a mean-reduced loss even when shards are
        unequal."""
        total = sum(weights)
        return {name: sum(w * g[name] for w, g in zip(weights, grads_list))
                / total for name in grads_list[0]}

    def _sharded_step(self, batch: Dict[str, Any]) -> Dict[str, float]:
        """One synchronized DP gradient step over the batch."""
        count = len(next(iter(batch.values())))
        splits = [idx for idx in np.array_split(np.arange(count), self._n)
                  if len(idx)]
        refs = [s.compute_grads.remote({k: v[idx] for k, v in batch.items()})
                for s, idx in zip(self._shards, splits)]
        outs = self._rt.get(refs)
        avg = self._average([g for g, _ in outs],
                            [len(idx) for idx in splits])
        self._rt.get([s.apply_grads.remote(avg) for s in self._shards])
        return outs[0][1]

    def update_from_batch(self, batch, *, num_epochs: int,
                          minibatch_size: int,
                          rng: np.random.Generator) -> Dict[str, float]:
        metrics: Dict[str, float] = {}
        mb = min(minibatch_size, batch.count)
        for _ in range(num_epochs):
            shuffled = batch.shuffle(rng)
            for sub in shuffled.minibatches(mb):
                metrics = self._sharded_step(dict(sub))
        return metrics

    def get_weights(self) -> Tensors:
        return self._rt.get(self._shards[0].get_weights.remote())

    def set_weights(self, w: Tensors) -> None:
        self._rt.get([s.set_weights.remote(w) for s in self._shards])

    def get_state(self):
        """Checkpoint state: shards are replicated, so shard 0 speaks for
        the group (``Algorithm.save_checkpoint`` calls this)."""
        return self._rt.get(self._shards[0].get_state.remote())

    def set_state(self, state) -> None:
        """Broadcast restored state to every shard, preserving the
        replication invariant."""
        self._rt.get([s.set_state.remote(state) for s in self._shards])

    def stop(self) -> None:
        for s in self._shards:
            self._rt.kill(s)
        self._shards = []
