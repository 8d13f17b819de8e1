"""Gang of training worker actors (port of ``ray_tpu/train/worker_group.py``).

Each worker actor hosts the user ``train_loop_per_worker`` on a background
thread and exposes ``poll``, which the trainer calls to drain reports. The
actors are made through a runtime (the runtime seam): a ``LocalRuntime``
by default, or any object with its calls, such as the ``ray_tpu`` module.
The user function goes to the workers as itself; the runtime's serializer
carries it.

Where the runtime has placement groups (``runtime.util.placement_group``)
the gang reserves one; the in-process runtime has none, since its actors
are objects of this process with nothing to reserve, and holds one rank
only (``check_gang``). A CUDA gang pins each rank's GPU, the one of its
local rank on its node (``gang_local_ranks``), through its
``runtime_env`` (``CUDA_VISIBLE_DEVICES``), so every rank computes on its
process's ``cuda:0``.

The supervisor finds dead members two ways, as the reference's does: the
GCS's actor-death push (the ``actor_state`` channel of the runtime's own
``experimental.pubsub``, drained each heartbeat) and bounded liveness
pings, which also catch a wedged rank that is still alive. The pubsub
comes from the runtime the group was given, never by an import of
another runtime: ``ray_tpu_torch.experimental.pubsub`` on the port's
runtime, the ``experimental.pubsub`` attribute of another runtime module
that has one loaded (the ``ray_tpu`` module, say). The in-process
``LocalRuntime`` has no GCS, so there the pings alone find a death. The
group subscribes as soon as its ranks exist, then reads each rank's state
once, by its actor id, through the state API found the same way
(``runtime_state_api``): a rank that died before the subscription was in
place sent its push to no one. A runtime with no state API loaded skips
that read.

A SIGKILLed rank's connections close at once, so a pending ping fails
before the GCS has heard of the death from the rank's node manager; the
ping's error then says only that the actor died. Where there is a push,
the supervisor waits for it, up to one heartbeat, so the gang error
carries the GCS's death cause (the reference records the ping's error).
The trainer's poll, which can see the dead rank first, waits for the
supervisor's gang error in turn (``wait_gang_error``).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch

from ray_tpu_torch._private.config import config
from ray_tpu_torch.device import DeviceLike, resolve_device
from ray_tpu_torch.exceptions import GangMemberDiedError
from ray_tpu_torch.parallel import collective
from ray_tpu_torch.runtime import LocalRuntime
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.util.metrics import Counter, Histogram

logger = logging.getLogger("ray_tpu_torch.train.gang")

_gang_metrics = None
_gang_metrics_lock = threading.Lock()


def runtime_pubsub(runtime: Any):
    """The pubsub module of ``runtime``, or None where it has none."""
    import ray_tpu_torch

    if runtime is ray_tpu_torch:
        from ray_tpu_torch.experimental import pubsub

        return pubsub
    return getattr(getattr(runtime, "experimental", None), "pubsub", None)


def runtime_state_api(runtime: Any):
    """The state API module of ``runtime`` (``experimental.state.api``),
    or None where it has none loaded."""
    import ray_tpu_torch

    if runtime is ray_tpu_torch:
        from ray_tpu_torch.experimental.state import api

        return api
    state = getattr(getattr(runtime, "experimental", None), "state", None)
    return getattr(state, "api", None)


def runtime_gcs(runtime: Any):
    """The GCS channel of ``runtime``'s connected worker in this process,
    or None (no cluster, or a runtime with none, as ``LocalRuntime``)."""
    import ray_tpu_torch

    if runtime is ray_tpu_torch:
        from ray_tpu_torch._private import worker as worker_mod
    else:
        worker_mod = getattr(getattr(runtime, "_private", None), "worker",
                             None)
    w = getattr(worker_mod, "global_worker", lambda: None)()
    return getattr(w, "gcs", None)


def _metrics():
    """The gang's counters (in-process, as the port's other metrics)."""
    global _gang_metrics
    with _gang_metrics_lock:
        if _gang_metrics is None:
            _gang_metrics = {
                "restarts": Counter(
                    "train_gang_restarts_total",
                    "Training gangs torn down and re-formed after a "
                    "gang-member death"),
                "poisoned": Counter(
                    "gang_poisoned_total",
                    "Collective groups poisoned after a gang-member death"),
                "detect": Histogram(
                    "gang_time_to_detection_seconds",
                    "Time from a gang member's last known-alive signal to "
                    "the supervisor declaring it dead",
                    boundaries=[0.1, 0.25, 0.5, 1.0, 2.0, 5.0, 10.0, 30.0,
                                60.0]),
            }
        return _gang_metrics


def check_gang(runtime: Any, num_workers: int) -> None:
    """Raise for a gang the in-process runtime cannot form: its calls run
    one after another in one process, a process holds one
    ``torch.distributed`` world and one collective group of a name, so a
    second rank would wait forever for the first."""
    if isinstance(runtime, LocalRuntime) and num_workers > 1:
        raise ValueError(
            f"the in-process LocalRuntime runs one rank, not {num_workers}: "
            f"a torch_dist world needs one process per rank and its ranks "
            f"must join at once. Pass a runtime with processes (such as the "
            f"ray_tpu_torch module).")


def gang_local_ranks(runtime: Any, pg: Any, num_workers: int,
                     bundle_offset: int = 0) -> List[int]:
    """Each rank's index among the gang's ranks on its node, in rank order.
    Where the runtime's placement-group table names the node of each
    bundle (``runtime.util.placement_group_table``), ranks count per node;
    without a placement group every rank counts as on one node."""
    nodes: List[Any] = [None] * num_workers
    table = getattr(getattr(runtime, "util", None), "placement_group_table",
                    None)
    if pg is not None and table is not None:
        by_index = {b["index"]: b.get("node_id")
                    for b in table(pg).get("bundles", [])}
        nodes = [by_index.get(bundle_offset + i) for i in range(num_workers)]
    seen: Dict[Any, int] = {}
    local = []
    for node in nodes:
        local.append(seen.get(node, 0))
        seen[node] = local[-1] + 1
    return local


def gang_device(runtime: Any, device: DeviceLike) -> torch.device:
    """The device the gang's ranks compute on (``cuda`` when None). The
    in-process runtime's rank is this process, so that device must exist
    here (``resolve_device`` raises otherwise). A runtime with processes
    places each rank where its device is, and the rank resolves it itself
    (``TrainWorker``): the process that forms the gang, a Tune trial's CPU
    actor say, needs no GPU of its own."""
    if isinstance(runtime, LocalRuntime):
        return resolve_device(device)
    return torch.device("cuda" if device is None else device)


def runtime_assigns_gpus(runtime: Any) -> bool:
    """True for a runtime whose node manager hands each GPU worker its own
    ``CUDA_VISIBLE_DEVICES`` (the port's own, ``ray_tpu_torch``)."""
    return bool(getattr(runtime, "ASSIGNS_GPUS", False))


def rank_runtime_env(runtime_env: Optional[Dict[str, Any]], local_rank: int,
                     device: torch.device) -> Dict[str, Any]:
    """``runtime_env`` plus, for a CUDA rank on a runtime that does not
    assign GPUs (``ray_tpu`` assigns only TPU chips), its GPU: the rank
    with local rank ``k`` sees only the ``k``-th GPU of its node, as its
    process's ``cuda:0``. A mask the user set (``CUDA_VISIBLE_DEVICES`` in
    ``runtime_env``'s ``env_vars``, else in this process's environment,
    which the runtime's workers inherit) is honoured: ``k`` indexes the
    GPUs it lists. A runtime that assigns GPUs (``runtime_assigns_gpus``)
    skips this: its rank keeps the node manager's mask as it is."""
    env = dict(runtime_env or {})
    if device.type == "cuda":
        env_vars = dict(env.get("env_vars") or {})
        mask = env_vars.get("CUDA_VISIBLE_DEVICES",
                            os.environ.get("CUDA_VISIBLE_DEVICES"))
        gpu = str(local_rank)
        if mask is not None:
            visible = [d.strip() for d in mask.split(",") if d.strip()]
            if local_rank >= len(visible):
                raise ValueError(
                    f"local rank {local_rank} needs a GPU of its own, but "
                    f"CUDA_VISIBLE_DEVICES={mask!r} lists {len(visible)}")
            gpu = visible[local_rank]
        env_vars["CUDA_VISIBLE_DEVICES"] = gpu
        env["env_vars"] = env_vars
    return env


class TrainWorker:
    """Actor hosting one rank of the training gang."""

    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 group_name: str, backend: str, experiment_name: str,
                 device: str = "cpu", runtime: Any = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.group_name = group_name
        self.backend = backend
        self.experiment_name = experiment_name
        self.device = collective._group_device(device)
        self._rt = runtime
        self._thread: Optional[threading.Thread] = None
        os.environ["RTPU_WORLD_RANK"] = str(world_rank)
        os.environ["RTPU_WORLD_SIZE"] = str(world_size)
        os.environ["RTPU_LOCAL_RANK"] = str(local_rank)

    def _has_group(self) -> bool:
        # A torch_dist gang always joins its world, one rank too, as
        # torch's own trainers always start a process group; a store gang
        # of one needs no coordinator.
        return self.world_size > 1 or self.backend == "torch_dist"

    def setup_collective(self):
        """Join the gang's collective group."""
        if self._has_group() and not collective.is_group_initialized(
                self.group_name):
            collective.init_collective_group(
                self.world_size, self.world_rank, backend=self.backend,
                group_name=self.group_name, device=self.device,
                runtime=self._rt)
        return True

    def start(self, fn: Callable, config: Optional[dict],
              checkpoint_path: Optional[str],
              dataset_shards: Optional[Dict[str, Any]] = None) -> bool:
        ckpt = Checkpoint(checkpoint_path) if checkpoint_path else None
        sess = session_mod._init_session(
            world_rank=self.world_rank, world_size=self.world_size,
            local_rank=self.local_rank, checkpoint=ckpt,
            experiment_name=self.experiment_name,
            collective_group_name=self.group_name if self._has_group()
            else "",
            dataset_shards=dataset_shards, device=self.device)

        def run():
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                if config is not None:
                    fn(config)
                else:
                    fn()
            except BaseException as e:  # surfaced via poll()
                sess.error = e
                sess.error_tb = traceback.format_exc()
            finally:
                sess.finished.set()

        self._thread = threading.Thread(target=run, daemon=True,
                                        name="rtpu-train-loop")
        self._thread.start()
        return True

    def ping(self) -> bool:
        """Liveness probe served by the actor's main thread (the user loop
        runs on a background thread, so a busy rank still answers)."""
        return True

    def poll(self) -> Dict[str, Any]:
        """Drain queued reports; non-blocking."""
        sess = session_mod._get_session()
        out_reports = []
        for r in sess.drain():
            ck: Optional[Checkpoint] = r["checkpoint"]
            out_reports.append({
                "metrics": r["metrics"],
                "checkpoint_path": ck.path if ck is not None else None,
            })
        state, error, error_type = "running", None, None
        if sess.finished.is_set():
            state = "errored" if sess.error is not None else "finished"
            if sess.error is not None:
                error = getattr(sess, "error_tb", str(sess.error))
                error_type = type(sess.error).__name__
        return {"reports": out_reports, "state": state, "error": error,
                "error_type": error_type}

    def teardown(self):
        try:
            if collective.is_group_initialized(self.group_name):
                collective.destroy_collective_group(self.group_name)
        # raylint: disable-next=exception-swallow (teardown path: a
        # GangMemberDiedError here means the group we are destroying is
        # already dead — the very condition teardown handles; the
        # session shutdown below must still run)
        except Exception:
            pass
        session_mod._shutdown_session()
        return True


class WorkerGroup:
    def __init__(self, num_workers: int,
                 resources_per_worker: Dict[str, float],
                 *, placement_strategy: str = "PACK",
                 backend: str = "store",
                 group_name: str = "train_default",
                 experiment_name: str = "",
                 runtime_env: Optional[Dict[str, Any]] = None,
                 existing_pg=None, bundle_offset: int = 0,
                 runtime: Any = None, device: DeviceLike = None):
        self._rt = LocalRuntime() if runtime is None else runtime
        check_gang(self._rt, num_workers)
        local = isinstance(self._rt, LocalRuntime)
        if local and runtime_env:
            raise ValueError("the in-process LocalRuntime cannot apply a "
                             "worker runtime_env")
        dev = gang_device(self._rt, device)
        self.num_workers = num_workers
        self.group_name = group_name
        pg_api = getattr(self._rt, "util", None)
        self._owns_pg = existing_pg is None
        self._bundle_offset = bundle_offset
        if existing_pg is not None:
            self.pg = existing_pg
        elif hasattr(pg_api, "placement_group"):
            bundles = ScalingConfig(
                num_workers=num_workers,
                resources_per_worker=dict(resources_per_worker)).bundles()
            self.pg = pg_api.placement_group(bundles,
                                             strategy=placement_strategy)
            self.pg.wait(timeout_seconds=60)
        else:
            self.pg = None

        # Supervision state, before any actor exists, so the failure path
        # can always call shutdown() on a half-built group.
        self._heartbeat_s = max(0.05, float(config.gang_heartbeat_s))
        self._ping_miss_limit = max(1, int(config.gang_ping_miss_limit))
        self._poll_timeout_s = float(config.gang_poll_timeout_s)
        self._get_timeout_error, _ = collective._runtime_errors(self._rt)
        self._dead_lock = threading.Lock()
        self._dead_ranks: Dict[int, str] = {}
        self._gang_error: Optional[GangMemberDiedError] = None
        self._gang_error_set = threading.Event()
        self._sub = None
        self._supervisor: Optional[threading.Thread] = None
        self._poisoned = False
        self._stop = threading.Event()
        self._last_alive: Dict[int, float] = {
            rank: time.time() for rank in range(num_workers)}
        self._pending_polls: Dict[int, Any] = {}
        self._actor_ids: Dict[str, int] = {}
        self.workers: List[Any] = []

        local_ranks = gang_local_ranks(self._rt, self.pg, num_workers,
                                       bundle_offset)
        cls = self._rt.remote(TrainWorker)
        try:
            for i in range(num_workers):
                opts: Dict[str, Any] = {
                    "num_cpus": resources_per_worker.get("CPU", 1),
                    "num_gpus": resources_per_worker.get("GPU", 0)}
                if self.pg is not None:
                    opts.update(placement_group=self.pg,
                                placement_group_bundle_index=i
                                + self._bundle_offset)
                if not local:
                    env = (runtime_env if runtime_assigns_gpus(self._rt) else
                           rank_runtime_env(runtime_env, local_ranks[i], dev))
                    if env:
                        opts["runtime_env"] = env
                self.workers.append(cls.options(**opts).remote(
                    world_rank=i, world_size=num_workers,
                    local_rank=local_ranks[i],
                    group_name=group_name, backend=backend,
                    experiment_name=experiment_name,
                    device=dev.type if not local else str(dev),
                    runtime=self._rt))
            # The GCS names an actor in its actor_state messages by the
            # hex of its id. Only a runtime with a pubsub has a GCS.
            if runtime_pubsub(self._rt) is not None:
                self._actor_ids = {w._actor_id.hex(): rank
                                   for rank, w in enumerate(self.workers)}
                self._subscribe_deaths()
            # All ranks join at once: a torch_dist rendezvous blocks every
            # rank until the whole world has joined. Bounded past the
            # members' own formation budgets.
            rendezvous_timeout = 4.0 * float(
                config.collective_rendezvous_timeout_s) + 60.0
            self._rt.get([w.setup_collective.remote()
                          for w in self.workers],
                         timeout=rendezvous_timeout)
        except BaseException:
            self.shutdown(graceful=False)
            raise
        self._supervisor = threading.Thread(
            target=self._supervise_loop, daemon=True,
            name=f"rtpu-gang-supervisor-{group_name}")
        self._supervisor.start()

    def _subscribe_deaths(self):
        """Subscribe to the GCS's ``actor_state`` push as soon as the ranks
        exist, then read each rank's state once by its actor id: a rank
        that died before the subscription was in place sent its push to no
        one, so only this read can see it. The supervisor thread drains
        the subscription from then on."""
        pubsub = runtime_pubsub(self._rt)
        try:
            self._sub = pubsub.subscribe("actor_state")
        except Exception:
            logger.debug("actor_state pubsub unavailable; death detection "
                         "falls back to liveness pings only", exc_info=True)
            return
        state_api = runtime_state_api(self._rt)
        if state_api is None:
            return
        for aid in self._actor_ids:
            try:
                entry = state_api.get_actor(aid)
            except Exception:
                logger.debug("could not read rank %d's actor state; the "
                             "push and the pings still watch it",
                             self._actor_ids[aid], exc_info=True)
                continue
            if entry is not None:
                self._on_actor_state(entry)

    # ------------------------------------------------------- gang liveness

    @property
    def gang_error(self) -> Optional[GangMemberDiedError]:
        return self._gang_error

    def _note_dead(self, rank: int, reason: str):
        """Record a dead member: observe time-to-detection (since its last
        known-alive signal) and poison the gang."""
        with self._dead_lock:
            if rank in self._dead_ranks:
                return
            self._dead_ranks[rank] = reason
        _metrics()["detect"].observe(max(
            0.0, time.time() - self._last_alive.get(rank, time.time())))
        self.poison(f"rank {rank} died: {reason}", rank=rank)

    def poison(self, reason: str, rank: Optional[int] = None):
        """Poison the gang's collective group so survivors wedged in a
        pending collective raise GangMemberDiedError within about 2x the
        heartbeat, and record the gang error the trainer restarts on."""
        with self._dead_lock:
            if self._gang_error is None:
                self._gang_error = GangMemberDiedError(
                    group_name=self.group_name, rank=rank, reason=reason)
                self._gang_error_set.set()
            if self._poisoned:
                return
            self._poisoned = True
        _metrics()["poisoned"].inc()
        collective.poison_group(self.group_name, reason, runtime=self._rt)
        # Slice death declared: every node dumps its flight recorder, so
        # the restart leaves a postmortem holding the dead rank's last
        # task events and the node's samples (dashboard/agent.py).
        gcs = runtime_gcs(self._rt)
        if gcs is not None:
            try:
                gcs.notify("flight_dump", {
                    "reason": f"gang {self.group_name} poisoned: {reason}"})
            except Exception:
                logger.warning("flight-recorder dump request failed after "
                               "gang poison", exc_info=True)

    def wait_gang_error(self) -> Optional[GangMemberDiedError]:
        """The gang error, once the supervisor has recorded one, waiting up
        to two heartbeats for it (a failed ping, then the GCS's push)."""
        self._gang_error_set.wait(2 * self._heartbeat_s)
        return self._gang_error

    def _supervise_loop(self):
        """Watch the gang for member death: GCS actor-failure notifications
        (the ``actor_state`` pubsub channel) plus a bounded liveness ping
        every ``gang_heartbeat_s``. Detection poisons the group's
        coordinator, so the trainer (``gang_error``) and the survivors
        (their watchers) see the death in bounded time, not at the op
        deadline."""
        sub = self._sub
        misses = {rank: 0 for rank in range(self.num_workers)}
        try:
            while not self._stop.wait(self._heartbeat_s):
                if sub is not None:
                    self._drain_deaths(sub)
                self._ping_round(misses)
        finally:
            self._sub = None
            if sub is not None:
                try:
                    sub.unsubscribe()
                # raylint: disable-next=exception-swallow (supervisor
                # exit cleanup: nothing downstream consumes this sub,
                # and the supervisor must not die un-unsubscribed)
                except Exception:
                    pass

    def _drain_deaths(self, sub):
        """Drain the GCS's actor-death notifications without blocking (the
        push path: no latency beyond the heartbeat)."""
        while True:
            try:
                msg = sub.get_nowait()
            except queue.Empty:
                return
            self._on_actor_state(msg)

    def _on_actor_state(self, msg):
        try:
            rank = self._actor_ids.get(msg.get("actor_id"))
            if rank is not None and msg.get("state") == "DEAD":
                self._note_dead(rank, msg.get("death_cause") or "actor died")
        except Exception:
            # A malformed death notification must not be dropped in
            # silence: the pings still catch the dead rank, but only at
            # their own pace.
            logger.warning("dropped a malformed actor_state death "
                           "notification: %r", msg, exc_info=True)

    def _await_push(self, rank: int) -> bool:
        """Wait up to one heartbeat for the GCS's push of ``rank``'s death
        (the ping that failed first knows no cause); True once the rank is
        noted dead."""
        sub = self._sub
        end = time.monotonic() + self._heartbeat_s
        while sub is not None:
            with self._dead_lock:
                if rank in self._dead_ranks:
                    return True
            remaining = end - time.monotonic()
            if remaining <= 0:
                return False
            try:
                msg = sub.get(timeout=remaining)
            except queue.Empty:
                return False
            self._on_actor_state(msg)
        return False

    def _ping_round(self, misses: Dict[int, int]):
        """One bounded liveness ping of every live member: a member that
        fails its ping is dead, one that misses ``gang_ping_miss_limit`` in
        a row is wedged. Every ping is submitted first, so one slow rank
        does not stretch the round (and the detection bound) by N
        timeouts."""
        with self._dead_lock:
            dead = set(self._dead_ranks)
        pings: Dict[int, Any] = {}
        for rank, w in enumerate(self.workers):
            if rank in dead or self._stop.is_set():
                continue
            try:
                pings[rank] = w.ping.remote()
            except Exception as e:
                if not self._await_push(rank):
                    self._note_dead(rank, f"actor died: {e}")
        round_deadline = time.monotonic() + self._heartbeat_s
        for rank, ref in pings.items():
            try:
                self._rt.get(ref, timeout=max(
                    0.05, round_deadline - time.monotonic()))
                self._last_alive[rank] = time.time()
                misses[rank] = 0
            except self._get_timeout_error:
                misses[rank] += 1
                if misses[rank] >= self._ping_miss_limit:
                    self._note_dead(
                        rank, f"unresponsive for {misses[rank]} "
                              f"heartbeats")
            except Exception as e:
                # The runtime's dead-actor errors: the actor is gone.
                if not self._await_push(rank):
                    self._note_dead(rank, f"actor died: {e}")

    def start(self, train_fn: Callable, run_config: Optional[dict],
              checkpoint: Optional[Checkpoint],
              datasets: Optional[Dict[str, Any]] = None):
        path = checkpoint.path if checkpoint is not None else None
        # Each dataset split lazily by blocks: every rank reads only its own.
        per_rank: List[Optional[Dict[str, Any]]] = [None] * self.num_workers
        if datasets:
            split = {name: ds.streaming_split(self.num_workers)
                     for name, ds in datasets.items()}
            per_rank = [{name: shards[r] for name, shards in split.items()}
                        for r in range(self.num_workers)]
        # A rank that cannot ack start() is wedged: fail this attempt (the
        # restart path re-forms the gang) instead of parking forever.
        self._rt.get(
            [w.start.remote(train_fn, run_config, path, per_rank[i])
             for i, w in enumerate(self.workers)],
            timeout=4 * float(config.collective_rendezvous_timeout_s)
            + 60.0)

    def poll(self) -> List[Dict[str, Any]]:
        """Drain every rank's reports with per-worker error isolation: a
        dead rank surfaces as ``state="dead"`` instead of one actor error
        aborting the whole poll batch."""
        refs: List[Any] = []
        for rank, w in enumerate(self.workers):
            # Re-await a previously timed-out poll: poll() drains the
            # worker's queue, so an abandoned ref would swallow reports.
            pending = self._pending_polls.pop(rank, None)
            if pending is not None:
                refs.append(pending)
                continue
            try:
                refs.append(w.poll.remote())
            except Exception as e:
                refs.append(e)
        out: List[Dict[str, Any]] = []
        deadline = time.monotonic() + self._poll_timeout_s
        for rank, ref in enumerate(refs):
            try:
                if isinstance(ref, Exception):
                    raise ref
                st = self._rt.get(ref, timeout=max(
                    0.1, deadline - time.monotonic()))
            except self._get_timeout_error:
                # Slow, not dead: the supervisor owns death detection.
                self._pending_polls[rank] = ref
                st = {"reports": [], "state": "running", "error": None,
                      "error_type": None}
            except Exception as e:
                st = {"reports": [], "state": "dead", "error": str(e),
                      "error_type": type(e).__name__}
                if self._sub is None:
                    # No push to wait for: this error is all there is.
                    # Otherwise the supervisor notes the death with the
                    # GCS's cause within a heartbeat or two.
                    self._note_dead(rank, f"actor died: {e}")
            out.append(st)
        return out

    def shutdown(self, graceful: bool = True):
        """Tear the gang down. ``graceful=False`` is the gang-death path:
        survivors may be wedged inside a poisoned collective, so skip the
        cooperative teardown and kill them; a fresh gang under a fresh
        group name replaces them."""
        self._stop.set()
        if self._supervisor is None and self._sub is not None:
            # Formation failed after the subscription: no supervisor
            # thread will unsubscribe it.
            sub, self._sub = self._sub, None
            try:
                sub.unsubscribe()
            # raylint: disable-next=exception-swallow (teardown of a
            # failed formation: the caller re-raises the real error)
            except Exception:
                pass
        if graceful and self._gang_error is None:
            try:
                self._rt.get([w.teardown.remote() for w in self.workers],
                             timeout=10)
            # raylint: disable-next=exception-swallow (cooperative
            # teardown is advisory: dead/wedged ranks are expected here
            # and the unconditional kill below is the real teardown)
            except Exception:
                pass
        for w in self.workers:
            try:
                self._rt.kill(w)
            # raylint: disable-next=exception-swallow (force-kill of a
            # possibly-already-dead actor: the error IS the goal state)
            except Exception:
                pass
        # The group coordinator is a detached named actor: rank 0 kills it
        # on graceful teardown; after a gang death nobody does.
        try:
            self._rt.kill(self._rt.get_actor(
                collective._COORD_NAME_FMT.format(self.group_name)))
        # raylint: disable-next=exception-swallow (coordinator reap:
        # "no such actor" — rank 0 already killed it on the graceful
        # path — is the common, correct outcome)
        except Exception:
            pass
        if self._owns_pg and self.pg is not None:
            try:
                self._rt.util.remove_placement_group(self.pg)
            # raylint: disable-next=exception-swallow (best-effort PG
            # cleanup on teardown; a re-formed gang allocates a fresh
            # PG regardless, and leaked PGs die with the job)
            except Exception:
                pass
