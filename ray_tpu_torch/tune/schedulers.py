"""Trial schedulers (port of ``ray_tpu/tune/schedulers.py``, pure Python:
the same reports give the same decisions; reference:
``tune/schedulers/``: FIFO, ASHA ``async_hyperband.py:17``, PBT
``pbt.py:310``).

The scheduler sees every reported result and decides CONTINUE, STOP, or
(PBT) an ``Exploit``: the runner then restarts the trial from the donor
trial's checkpoint with a mutated config.
"""

from __future__ import annotations

import dataclasses
import random
from collections import defaultdict
from typing import Any, Callable, Dict, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


@dataclasses.dataclass
class Exploit:
    """PBT decision: clone ``donor``'s checkpoint, run with ``config``."""

    donor: str
    config: Dict[str, Any]


class FIFOScheduler:
    def on_result(self, trial_id: str, result: Dict) -> str:
        return CONTINUE


class AsyncHyperBandScheduler:
    """ASHA: asynchronous successive halving. A trial reaching rung r
    (iteration = grace_period * reduction_factor**r) continues only if its
    metric is in the top 1/reduction_factor of completed rung-r records
    seen so far (async — no waiting for the full cohort, reference:
    ``async_hyperband.py`` _Bracket.on_result)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        self._rungs: Dict[int, list] = defaultdict(list)
        self._rung_levels = []
        t = grace_period
        while t < max_t:
            self._rung_levels.append(t)
            t *= reduction_factor

    def on_result(self, trial_id: str, result: Dict) -> str:
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if t is None or value is None:
            return CONTINUE
        if t >= self.max_t:
            return STOP
        decision = CONTINUE
        for level in self._rung_levels:
            if t == level:
                rung = self._rungs[level]
                rung.append(value if self.mode == "min" else -value)
                rung.sort()
                cutoff_idx = max(0, len(rung) // self.rf - 1) \
                    if len(rung) >= self.rf else None
                mine = value if self.mode == "min" else -value
                if cutoff_idx is not None and mine > rung[cutoff_idx]:
                    decision = STOP
        return decision


ASHAScheduler = AsyncHyperBandScheduler


class HyperBandScheduler:
    """HyperBand (reference: ``tune/schedulers/hyperband.py:40``):
    s_max+1 brackets trading off number of configurations against budget
    per configuration — bracket s starts trials with grace period
    max_t / rf^s, so one bracket explores many short runs while another
    gives few trials the full budget. Trials are assigned to brackets
    round-robin on add; within a bracket, rung promotion uses the
    asynchronous top-1/rf rule (a simplification of the reference's
    synchronous cohort halving: no barrier, no idle accelerators while a
    cohort straggles)."""

    def __init__(self, metric: str = "loss", mode: str = "min",
                 max_t: int = 81, reduction_factor: int = 3,
                 time_attr: str = "training_iteration"):
        assert mode in ("min", "max")
        import math

        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        s_max = int(math.log(max_t, reduction_factor))
        self._brackets = []
        for s in range(s_max, -1, -1):
            grace = max(1, max_t // (reduction_factor ** s))
            self._brackets.append(AsyncHyperBandScheduler(
                metric=metric, mode=mode, max_t=max_t,
                grace_period=grace, reduction_factor=reduction_factor,
                time_attr=time_attr))
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def on_trial_add(self, trial_id: str, config: Dict[str, Any]):
        self._assignment[trial_id] = self._next % len(self._brackets)
        self._next += 1

    def on_result(self, trial_id: str, result: Dict) -> str:
        idx = self._assignment.get(trial_id)
        if idx is None:   # late registration (searcher-mode trials)
            self.on_trial_add(trial_id, {})
            idx = self._assignment[trial_id]
        return self._brackets[idx].on_result(trial_id, result)


class PopulationBasedTraining:
    """PBT (reference: ``tune/schedulers/pbt.py:310``
    PopulationBasedTraining._exploit/_explore): every
    ``perturbation_interval`` iterations, a bottom-quantile trial clones a
    top-quantile trial's checkpoint and continues with a perturbed copy of
    the donor's hyperparameters."""

    def __init__(self, metric: str, mode: str = "max",
                 perturbation_interval: int = 4,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration", seed: int = 0):
        assert mode in ("min", "max")
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_p = resample_probability
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: Dict[str, float] = {}
        self._last_perturb: Dict[str, int] = {}
        self.num_exploits = 0

    # Runner hook: configs are needed to mutate the donor's.
    def on_trial_add(self, trial_id: str, config: Dict[str, Any]):
        self._configs[trial_id] = dict(config)

    def _sample(self, spec) -> Any:
        if callable(spec) and not hasattr(spec, "sample"):
            return spec()
        if hasattr(spec, "sample"):
            return spec.sample(self._rng)
        return self._rng.choice(list(spec))

    def _explore(self, donor_cfg: Dict[str, Any]) -> Dict[str, Any]:
        cfg = dict(donor_cfg)
        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_p or \
                    not isinstance(cfg.get(key), (int, float)):
                cfg[key] = self._sample(spec)
            else:
                cfg[key] = cfg[key] * self._rng.choice((0.8, 1.2))
        return cfg

    def on_result(self, trial_id: str, result: Dict):
        t = result.get(self.time_attr)
        value = result.get(self.metric)
        if value is None or t is None:
            return CONTINUE
        self._scores[trial_id] = float(value)
        if t - self._last_perturb.get(trial_id, 0) < self.interval:
            return CONTINUE
        self._last_perturb[trial_id] = t
        scored = sorted(
            self._scores.items(), key=lambda kv: kv[1],
            reverse=(self.mode == "max"))
        if len(scored) < 2:
            return CONTINUE
        k = max(1, int(len(scored) * self.quantile))
        top = [tid for tid, _ in scored[:k]]
        bottom = {tid for tid, _ in scored[-k:]}
        if trial_id not in bottom or trial_id in top:
            return CONTINUE
        donor = self._rng.choice(top)
        new_cfg = self._explore(self._configs.get(donor, {}))
        self._configs[trial_id] = new_cfg
        self.num_exploits += 1
        return Exploit(donor=donor, config=new_cfg)
