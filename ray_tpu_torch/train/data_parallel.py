"""Data-parallel trainer (port of ``ray_tpu/train/data_parallel.py``).

``fit()`` forms a gang of worker actors through the runtime, wires them
into a collective group, runs the user loop, streams reports, persists
rank 0's checkpoints under the run directory, and on a worker failure
re-forms the whole gang from the latest checkpoint, with backoff: the gang
is the failure domain. The ranks compute on ``device`` (``cuda`` unless
the caller passes another); without a GPU the trainer raises rather than
run on the CPU.
"""

from __future__ import annotations

import logging
import os
import shutil
import time
import uuid
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch._private.config import config
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.exceptions import GangMemberDiedError
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import Result, RunConfig, ScalingConfig
from ray_tpu_torch.train.worker_group import WorkerGroup, _metrics, check_gang

logger = logging.getLogger("ray_tpu_torch.train")

_POLL_PERIOD_S = 0.1


class DataParallelTrainer:
    _default_backend = "store"

    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[Dict[str, Any]] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        backend: Optional[str] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
        datasets: Optional[Dict[str, Any]] = None,
        runtime: Any = None,
        device: DeviceLike = None,
    ):
        self._train_loop = train_loop_per_worker
        self._config = train_loop_config
        self._datasets = datasets
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self._backend = backend or self._default_backend
        self._resume_from = resume_from_checkpoint
        self._runtime = LocalRuntime() if runtime is None else runtime
        self._device = resolve_device(device)
        check_gang(self._runtime, self.scaling_config.num_workers)

    # ----------------------------------------------------------------- fit

    def fit(self) -> Result:
        name = self.run_config.name or f"train_{uuid.uuid4().hex[:8]}"
        run_dir = os.path.join(self.run_config.resolved_storage_path(), name)
        os.makedirs(run_dir, exist_ok=True)

        max_failures = self.run_config.failure_config.max_failures
        attempts_left = float("inf") if max_failures < 0 else max_failures + 1
        latest_ckpt = self._resume_from
        last_error: Optional[BaseException] = None
        history = []
        ckpt_index = 0
        num_restarts = 0
        restart_reasons = []
        backoff = float(config.gang_restart_backoff_s)
        backoff_max = float(config.gang_restart_backoff_max_s)

        while attempts_left > 0:
            attempts_left -= 1
            existing_pg = getattr(self, "_existing_pg", None)
            # Every attempt re-forms the gang from scratch: fresh actors, a
            # fresh group name (a poisoned coordinator or a half-dead world
            # never leaks into the next attempt) and, where the gang owns
            # its placement group, a fresh reservation.
            group = None
            gang_death = False
            error = None
            interrupted = False
            progress = {"ckpt": latest_ckpt, "idx": ckpt_index}
            try:
                group = WorkerGroup(
                    self.scaling_config.num_workers,
                    self.scaling_config.worker_resources(),
                    placement_strategy=(
                        self.scaling_config.placement_strategy),
                    backend=self._backend,
                    group_name=f"train_{name}_{uuid.uuid4().hex[:6]}",
                    experiment_name=name,
                    runtime_env=self.scaling_config.worker_runtime_env,
                    existing_pg=existing_pg,
                    bundle_offset=1 if existing_pg is not None else 0,
                    runtime=self._runtime, device=self._device)
                group.start(self._train_loop, self._config, latest_ckpt,
                            datasets=self._datasets)
                error = self._drive(group, run_dir, history, progress)
            except (KeyboardInterrupt, SystemExit):
                # User interrupts are not gang failures: tear down (in the
                # finally) and propagate instead of re-forming.
                interrupted = True
                raise
            except BaseException as e:
                # A rank dying mid-rendezvous surfaces here as an actor
                # error or a formation timeout: a restartable gang failure.
                error = e
            finally:
                # Checkpoint progress survives a raising attempt: the
                # restart resumes from what actually persisted.
                latest_ckpt = progress["ckpt"]
                ckpt_index = progress["idx"]
                if group is not None:
                    gang_death = (isinstance(error, GangMemberDiedError)
                                  or group.gang_error is not None)
                    if gang_death and group.gang_error is not None \
                            and not isinstance(error, GangMemberDiedError):
                        # The root cause (the dead rank), not a survivor's
                        # secondary transport error.
                        error = group.gang_error
                    group.shutdown(
                        graceful=not (gang_death or interrupted))
                else:
                    gang_death = isinstance(error, GangMemberDiedError)
            if error is None:
                return Result(
                    metrics=history[-1] if history else None,
                    checkpoint=latest_ckpt, path=run_dir,
                    metrics_history=history, num_restarts=num_restarts,
                    restart_reasons=restart_reasons)
            last_error = error
            if attempts_left > 0:
                num_restarts += 1
                restart_reasons.append(f"{type(error).__name__}: {error}")
                if gang_death:
                    _metrics()["restarts"].inc()
                delay = min(backoff * (2 ** (num_restarts - 1)),
                            backoff_max)
                logger.warning(
                    "gang attempt failed (%s); re-forming from %s in "
                    "%.1fs (%d attempts left)", error,
                    latest_ckpt.path if latest_ckpt else "scratch",
                    delay, attempts_left)
                time.sleep(delay)
        return Result(metrics=history[-1] if history else None,
                      checkpoint=latest_ckpt, path=run_dir,
                      error=last_error, metrics_history=history,
                      num_restarts=num_restarts,
                      restart_reasons=restart_reasons)

    # ---------------------------------------------------------------- drive

    def _drive(self, group: WorkerGroup, run_dir: str, history: list,
               progress: Dict[str, Any]):
        """Poll until every worker finishes; persist rank 0's checkpoints.
        Checkpoint advancement is written through ``progress`` in place so
        fit() sees it even when this raises mid-attempt."""
        keep = self.run_config.checkpoint_config.num_to_keep
        # run_dir persists across restarts: earlier attempts' checkpoints
        # count against num_to_keep too.
        try:
            kept: list = sorted(
                os.path.join(run_dir, d) for d in os.listdir(run_dir)
                if d.startswith("checkpoint_"))
        except OSError:
            kept = []
        while True:
            states = group.poll()
            for rank, st in enumerate(states):
                for rep in st["reports"]:
                    if rank != 0:
                        continue
                    if rep["checkpoint_path"]:
                        progress["idx"] += 1
                        dst = os.path.join(
                            run_dir, f"checkpoint_{progress['idx']:06d}")
                        progress["ckpt"] = Checkpoint(
                            rep["checkpoint_path"]).move_to(dst)
                        kept.append(dst)
                        if keep and len(kept) > keep:
                            shutil.rmtree(kept.pop(0), ignore_errors=True)
                    history.append(rep["metrics"])
            # A gang-member death is a restart condition, not an
            # application error.
            dead = [(r, st) for r, st in enumerate(states)
                    if st["state"] == "dead"]
            if dead or group.gang_error is not None:
                err = group.gang_error
                if err is None:
                    rank, st = dead[0]
                    err = GangMemberDiedError(
                        group_name=group.group_name, rank=rank,
                        reason=st["error"] or "actor died")
                return err
            errored = [(r, st) for r, st in enumerate(states)
                       if st["state"] == "errored"]
            gang_errored = [
                (r, st) for r, st in errored
                if st.get("error_type") == "GangMemberDiedError"]
            if gang_errored:
                # A survivor saw a peer die before the supervisor did:
                # poison the rest of the gang and restart.
                rank, st = gang_errored[0]
                group.poison(f"rank {rank} observed gang death")
                return group.gang_error
            if errored:
                rank, st = errored[0]
                return TrainWorkerError(rank, st["error"])
            if all(st["state"] == "finished" for st in states):
                return None
            time.sleep(_POLL_PERIOD_S)


class TrainWorkerError(RuntimeError):
    def __init__(self, rank: int, tb: str):
        super().__init__(f"train worker rank {rank} failed:\n{tb}")
        self.rank = rank


class TorchDistTrainer(DataParallelTrainer):
    """DataParallelTrainer whose ranks join one ``torch.distributed`` world
    (the counterpart of ``JaxTrainer``): the gradient allreduce is a NCCL
    collective on a CUDA gang, gloo on a CPU one. Pass ``backend="store"``
    for the coordinator's numpy path."""

    _default_backend = "torch_dist"
