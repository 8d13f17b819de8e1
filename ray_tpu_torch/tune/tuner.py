"""Tuner + trial event loop (port of ``ray_tpu/tune/tuner.py``; reference:
``tune/tuner.py:47,327`` Tuner,
``tune/execution/trial_runner.py:61`` TrialRunner,
``tune/execution/ray_trial_executor.py:185`` actor placement).

Each trial is a function trainable hosted in a ``TrainWorker`` actor
(world size 1), reusing the train session/report pipe. The runner loop
launches trials up to ``max_concurrent_trials``, drains reports, lets the
scheduler stop laggards, retries failures, and persists per-trial
checkpoints under the experiment dir.

Trials run on the port's own runtime (``ray_tpu_torch``). The trial
function goes to its actor as itself, carried by the runtime's pickler
(``_private/pickler.py``): a function of ``__main__`` travels by value. A
trial that holds a GPU computes on ``cuda``, one without on the CPU. The
default concurrency counts every resource a trial asks for, GPUs too, so
the runner never launches a trial the cluster cannot place.
"""

from __future__ import annotations

import dataclasses
import os
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig
from ray_tpu_torch.tune.schedulers import (
    CONTINUE, Exploit, FIFOScheduler, STOP,
)
from ray_tpu_torch.tune.search import BasicVariantGenerator

_POLL_PERIOD_S = 0.05


@dataclasses.dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "min"
    num_samples: int = 1
    max_concurrent_trials: Optional[int] = None
    scheduler: Any = None
    # Model-based searcher (reference: tune/search/searcher.py seam):
    # when set, trial configs come from search_alg.suggest() as trials
    # launch (so the model learns from every completed trial) instead of
    # up-front random/grid variants.
    search_alg: Any = None
    resources_per_trial: Optional[Dict[str, float]] = None
    seed: Optional[int] = None


class Trial:
    def __init__(self, trial_id: str, config: Dict[str, Any]):
        self.trial_id = trial_id
        self.config = config
        self.state = "PENDING"   # RUNNING / TERMINATED / ERROR / STOPPED
        self.actor = None
        self.pg = None           # reserved group (PlacementGroupFactory)
        self.reports: List[Dict[str, Any]] = []
        self.checkpoint: Optional[Checkpoint] = None
        self.error: Optional[str] = None
        self.retries = 0
        self.iteration = 0

    def last_metrics(self) -> Optional[Dict[str, Any]]:
        return self.reports[-1] if self.reports else None


class ResultGrid:
    def __init__(self, results: List[Result], trials: List[Trial],
                 metric: Optional[str], mode: str):
        self._results = results
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i) -> Result:
        return self._results[i]

    @property
    def errors(self):
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (set in TuneConfig or here)")
        best, best_v = None, None
        for r in self._results:
            if r.metrics is None or metric not in r.metrics:
                continue
            v = r.metrics[metric]
            better = (best_v is None or
                      (v < best_v if mode == "min" else v > best_v))
            if better:
                best, best_v = r, v
        if best is None:
            raise RuntimeError(f"no trial reported metric {metric!r}")
        return best

    @property
    def dataframe(self):
        rows = []
        for t in self._trials:
            row = {"trial_id": t.trial_id, "state": t.state, **t.config}
            if t.last_metrics():
                row.update(t.last_metrics())
            rows.append(row)
        return rows


class Tuner:
    def __init__(self, trainable: Callable, *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None):
        self._trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()

    # ----------------------------------------------------------------- fit

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.train.data_parallel import DataParallelTrainer
        from ray_tpu_torch.train.worker_group import TrainWorker

        name = self.run_config.name or f"tune_{uuid.uuid4().hex[:8]}"
        exp_dir = os.path.join(self.run_config.resolved_storage_path(), name)
        os.makedirs(exp_dir, exist_ok=True)

        searcher = self.tune_config.search_alg
        if searcher is not None:
            searcher.set_search_properties(
                self.tune_config.metric, self.tune_config.mode,
                self.param_space)
            # Configs are suggested at LAUNCH, not up front: with
            # bounded concurrency the model sees completed trials
            # before proposing the next config.
            trials = [Trial(f"{name}_{i:05d}", None)
                      for i in range(self.tune_config.num_samples)]
        else:
            variants = BasicVariantGenerator(
                self.param_space, self.tune_config.num_samples,
                seed=self.tune_config.seed).variants()
            trials = [Trial(f"{name}_{i:05d}", cfg)
                      for i, cfg in enumerate(variants)]

        if isinstance(self._trainable, DataParallelTrainer):
            trial_fn = _trainer_trial_fn(self._trainable)
        else:
            trial_fn = self._trainable

        scheduler = self.tune_config.scheduler or FIFOScheduler()
        if hasattr(scheduler, "on_trial_add") and searcher is None:
            for t in trials:
                scheduler.on_trial_add(t.trial_id, t.config)
        from ray_tpu_torch.tune.placement_groups import PlacementGroupFactory
        from ray_tpu_torch.util.placement_group import placement_group

        res = self.tune_config.resources_per_trial or {"CPU": 1.0}
        pg_factory = res if isinstance(res, PlacementGroupFactory) else None
        max_conc = self.tune_config.max_concurrent_trials
        if max_conc is None:
            max_conc = _default_concurrency(
                pg_factory.bundles if pg_factory is not None else [res],
                len(trials))
        max_failures = self.run_config.failure_config.max_failures
        worker_cls = ray_tpu_torch.remote(TrainWorker)

        def launch(trial: Trial):
            if trial.config is None:
                trial.config = dict(searcher.suggest(trial.trial_id))
                if hasattr(scheduler, "on_trial_add"):
                    scheduler.on_trial_add(trial.trial_id, trial.config)
            opts: Dict[str, Any] = {}
            config = dict(trial.config)
            if pg_factory is not None:
                # Atomic gang reservation (reference:
                # tune/execution/placement_groups.py): the whole trial —
                # driver + inner trainer workers — places as ONE group,
                # so concurrent multi-worker trials can never deadlock on
                # partial placement. Bundle 0 hosts the trial driver; the
                # inner trainer gang takes bundles 1..N.
                trial.pg = placement_group(pg_factory.bundles,
                                           strategy=pg_factory.strategy)
                if not trial.pg.wait(timeout_seconds=120):
                    raise RuntimeError(
                        f"trial {trial.trial_id}: placement group not "
                        f"ready (cluster too small for "
                        f"{pg_factory.bundles}?)")
                head = pg_factory.head_bundle
                opts = dict(num_cpus=head.get("CPU", 1),
                            num_gpus=head.get("GPU", 0),
                            placement_group=trial.pg,
                            placement_group_bundle_index=0)
                config["__trial_pg__"] = trial.pg
            else:
                opts = dict(num_cpus=res.get("CPU", 1),
                            num_gpus=res.get("GPU", 0))
            # The trainer's rule: a rank that holds a GPU computes on it.
            trial.actor = worker_cls.options(**opts).remote(
                world_rank=0, world_size=1, local_rank=0,
                group_name="", backend="store", experiment_name=name,
                device="cuda" if opts["num_gpus"] else "cpu")
            ckpt_path = trial.checkpoint.path if trial.checkpoint else None
            ray_tpu_torch.get(trial.actor.start.remote(
                trial_fn, config, ckpt_path))
            trial.state = "RUNNING"

        while True:
            running = [t for t in trials if t.state == "RUNNING"]
            pending = [t for t in trials if t.state == "PENDING"]
            for t in pending[:max_conc - len(running)]:
                launch(t)
            running = [t for t in trials if t.state == "RUNNING"]
            if not running and not pending:
                break

            polls = ray_tpu_torch.get(
                [t.actor.poll.remote() for t in running])
            for trial, st in zip(running, polls):
                stop = False
                exploit = None
                for rep in st["reports"]:
                    trial.iteration += 1
                    metrics = dict(rep["metrics"])
                    metrics.setdefault("training_iteration", trial.iteration)
                    trial.reports.append(metrics)
                    if searcher is not None:
                        searcher.on_trial_result(trial.trial_id, metrics)
                    if rep["checkpoint_path"]:
                        dst = os.path.join(exp_dir, trial.trial_id,
                                           f"checkpoint_{trial.iteration:06d}")
                        trial.checkpoint = Checkpoint(
                            rep["checkpoint_path"]).move_to(dst)
                    decision = scheduler.on_result(trial.trial_id, metrics)
                    if decision == STOP:
                        stop = True
                    elif isinstance(decision, Exploit):
                        exploit = decision
                if exploit is not None and st["state"] == "running":
                    # PBT exploit/explore: restart from the donor's
                    # checkpoint with the mutated config (reference:
                    # pbt.py _exploit cloning trial state).
                    self._stop_actor(trial)
                    donor = next((t for t in trials
                                  if t.trial_id == exploit.donor), None)
                    if donor is not None and donor.checkpoint is not None:
                        trial.checkpoint = donor.checkpoint
                    trial.config = dict(exploit.config)
                    trial.state = "PENDING"
                    continue
                if st["state"] == "errored":
                    self._stop_actor(trial)
                    if max_failures < 0 or trial.retries < max_failures:
                        trial.retries += 1
                        trial.state = "PENDING"  # restart (from last ckpt)
                    else:
                        trial.state = "ERROR"
                        trial.error = st["error"]
                        if searcher is not None:
                            searcher.on_trial_complete(trial.trial_id,
                                                       error=True)
                elif st["state"] == "finished":
                    self._stop_actor(trial)
                    trial.state = "TERMINATED"
                    if searcher is not None:
                        searcher.on_trial_complete(
                            trial.trial_id, trial.last_metrics())
                elif stop:
                    self._stop_actor(trial)
                    trial.state = "STOPPED"
                    if searcher is not None:
                        # Scheduler-pruned: its best-so-far still informs
                        # the model (reference: ASHA + searcher compose).
                        searcher.on_trial_complete(
                            trial.trial_id, trial.last_metrics())
            time.sleep(_POLL_PERIOD_S)

        results = [
            Result(metrics=t.last_metrics(), checkpoint=t.checkpoint,
                   path=os.path.join(exp_dir, t.trial_id),
                   error=RuntimeError(t.error) if t.error else None,
                   metrics_history=t.reports)
            for t in trials
        ]
        return ResultGrid(results, trials, self.tune_config.metric,
                          self.tune_config.mode)

    @staticmethod
    def _stop_actor(trial: Trial):
        try:
            ray_tpu_torch.get(trial.actor.teardown.remote(), timeout=5)
        except Exception:
            pass
        try:
            ray_tpu_torch.kill(trial.actor)
        except Exception:
            pass
        trial.actor = None
        if trial.pg is not None:
            from ray_tpu_torch.util.placement_group import (
                remove_placement_group,
            )

            try:
                remove_placement_group(trial.pg)
            except Exception:
                pass
            trial.pg = None


def _trainer_trial_fn(trainer):
    """Wrap a DataParallelTrainer as a function trainable: each trial runs
    ``trainer.fit()`` with the trial config merged into train_loop_config
    (reference: ``tune/trainable/util.py`` trainable conversion —
    Train-on-Tune, base_trainer.py:538). The copy holds the trainer's
    runtime, device and datasets, never a tensor: no CUDA state of the
    driver travels with it."""
    import copy

    def run(config):
        from ray_tpu_torch.train import session as sess_mod

        config = dict(config)
        trial_pg = config.pop("__trial_pg__", None)
        t = copy.copy(trainer)
        if trial_pg is not None:
            # Reuse the trial's reserved group for the inner gang
            # (bundles 1..N; see tune/placement_groups.py).
            t._existing_pg = trial_pg
        merged = dict(t._config or {})
        merged.update(config.get("train_loop_config", config))
        t._config = merged
        result = t.fit()
        if result.error is not None:
            raise result.error
        for m in result.metrics_history:
            sess_mod.report(m)

    return run


def _default_concurrency(bundles: List[Dict[str, float]],
                         num_trials: int) -> int:
    """Default concurrency = what the cluster can actually place.
    launch() blocks until the trial actor is up, and running trial actors
    hold their resources until POLLED — launching more trials than
    capacity would deadlock the runner on a trial that can never place
    (reference: trial runner only starts trials the executor has
    resources for, ray_trial_executor.py:185). Every resource a trial asks
    for counts, GPUs too: the fewest trials any of them allows. A resource
    the cluster does not have yet (a GPU an autoscaler will launch)
    allows one trial at a time."""
    per: Dict[str, float] = {}
    for b in bundles:
        for k, v in b.items():
            if v:
                per[k] = per.get(k, 0.0) + float(v)
    try:
        total = ray_tpu_torch.cluster_resources()
    except Exception:
        return max(1, num_trials)
    if not per:
        return max(1, num_trials)
    return max(1, min(int(total.get(k, 0.0) // v) for k, v in per.items()))
