"""Serve controller actor (the port's copy of
``ray_tpu/serve/controller.py``; reference: ``serve/controller.py:68`` — a
detached actor running a reconciliation loop;
``_private/deployment_state.py:1855`` DeploymentStateManager).

Holds target state per deployment (replica count, config), reconciles
actual replica actors toward it in a background thread, autoscales from
replica queue stats, and PUSHES the replica directory to handles/proxies
through a versioned long-poll channel (reference: LongPollHost
``_private/long_poll.py:185,68`` — ``listen_for_change`` parks until a
watched key advances past the caller's snapshot). Replica death is
detected from the GCS actor-state pubsub channel (reference:
``_private/deployment_state.py:998`` liveness from actor events), not
probe-miss counting — stat probes only feed autoscaling, with a long
miss threshold kept as a backstop for wedged-but-alive replicas.

On the port a replica may hold GPUs (``ray_actor_options={"num_gpus":
n}``): its worker is spawned with its own ``CUDA_VISIBLE_DEVICES``, and a
replacement first waits for the GPU its dead predecessor held. The
controller and the proxies take no GPU and never touch CUDA.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Set

CONTROLLER_NAME = "SERVE_CONTROLLER"
_RECONCILE_PERIOD_S = 0.2
_STATS_TIMEOUT_S = 2.0
# A replica is replaced only after this many consecutive missed probes
# (~6s busy) — long user requests must not look like death.
_MAX_PROBE_MISSES = 30

_metrics_lock = threading.Lock()
_metrics: Optional[Dict[str, Any]] = None


def _fault_metrics() -> Dict[str, Any]:
    global _metrics
    with _metrics_lock:
        if _metrics is None:
            from ray_tpu_torch.util.metrics import Counter, Histogram

            _metrics = {
                "restarts": Counter(
                    "serve_replica_restarts_total",
                    "Replica deaths detected (pubsub or probe) that "
                    "triggered a replacement spawn.",
                    tag_keys=("deployment",)),
                "drain": Histogram(
                    "serve_drain_duration_seconds",
                    "Rolling-restart drain duration per replica, from "
                    "drain RPC issue to teardown.",
                    tag_keys=("deployment",)),
                "replace": Histogram(
                    "serve_replica_time_to_replace_seconds",
                    "Death detection to replacement replica answering "
                    "its first stats probe.",
                    tag_keys=("deployment",)),
            }
        return _metrics


def _load_from_stats(s: dict) -> float:
    """A replica's routing/autoscaling load: plain deployments report
    in-flight requests; engine deployments (serve.llm) override with
    ``autoscale_load`` = queue depth + busy slots."""
    return float(s.get("autoscale_load", s.get("ongoing", 0)))


class _DeploymentState:
    def __init__(self, config: dict, callable_blob: bytes,
                 init_args, init_kwargs):
        self.config = config
        self.blob = callable_blob
        self.init_args = init_args
        self.init_kwargs = init_kwargs
        self.replicas: List[Any] = []        # actor handles
        self.target = config["num_replicas"]
        self.last_scale_ts = 0.0
        self.deleting = False
        # (ts, total_load) samples for the autoscaler's look-back window.
        self.ongoing_history: List[tuple] = []
        # Last per-replica load observed by the probe sweep, keyed by
        # actor id hex — piggybacked on the replicas long-poll channel
        # so handles route with ZERO hot-path stats RPCs.
        self.pushed_stats: Dict[str, float] = {}
        # monotonic timestamps of detected replica deaths whose
        # replacement has not been spawned yet (time-to-replace clock).
        self.death_pending: List[float] = []
        # Replicas a _scale_to_target has claimed and not yet appended:
        # deploy() and the reconcile loop both scale, and each must see
        # the other's spawns in flight, or both fill the same deficit.
        self.spawning = 0


class ServeController:
    def __init__(self, http_port: Optional[int] = None,
                 system_config: Optional[dict] = None):
        if system_config:
            from ray_tpu_torch._private.config import config

            config.apply_system_config(system_config)
        self._system_config = dict(system_config or {})
        self._deployments: Dict[str, _DeploymentState] = {}
        self._miss_counts: Dict[int, int] = {}
        self._dead_counts: Dict[int, int] = {}
        # Replicas draining for a rolling restart / scale-down:
        # {"name", "replica", "ref", "start", "deadline"} — reaped (and
        # only then killed) by _reap_draining each reconcile tick.
        self._draining: List[dict] = []
        # id(replacement handle) -> (deployment, death detection ts):
        # closed out at the replacement's first successful stats probe.
        self._replacing: Dict[int, tuple] = {}
        self._fault: Dict[str, Any] = {"restarts": 0,
                                       "time_to_replace_s": [],
                                       "drain_duration_s": []}
        self._lock = threading.RLock()
        self._running = True
        self._http_port = http_port
        self._proxies: Dict[str, dict] = {}   # node_id -> {actor, port}
        self._proxy_backoff: Dict[str, float] = {}   # node_id -> retry at
        # Nodes whose proxy a reconcile is starting right now. __init__'s
        # reconcile and the loop's would otherwise both see a node
        # without a proxy and both start one; the second falls back to an
        # ephemeral port and replaces the first in the table, which then
        # serves its port unlisted and is never killed. A reconcile
        # claims a node here under _lock and starts its proxy outside
        # any lock (the bounded get of its port included).
        self._proxy_starting: Set[str] = set()
        # Long-poll state: key -> monotonically increasing version.
        self._versions: Dict[str, int] = {}
        self._change_cv = threading.Condition()
        try:
            from ray_tpu_torch.util.metrics import start_reporter

            start_reporter()
        except Exception:
            pass
        self._thread = threading.Thread(target=self._reconcile_loop,
                                        daemon=True, name="serve-reconcile")
        self._thread.start()
        self._death_sub = None
        threading.Thread(target=self._actor_death_loop, daemon=True,
                         name="serve-death-watch").start()
        if http_port is not None:
            self._start_proxy(http_port)

    # ------------------------------------------------------- long poll

    def _bump(self, key: str):
        with self._change_cv:
            self._versions[key] = self._versions.get(key, 0) + 1
            self._change_cv.notify_all()

    def _snapshot(self, key: str):
        if key.startswith("replicas:"):
            name = key.split(":", 1)[1]
            with self._lock:
                st = self._deployments.get(name)
                if st is None:
                    return {"replicas": [], "ongoing": {}}
                return {"replicas": list(st.replicas),
                        "ongoing": dict(st.pushed_stats)}
        if key == "routes":
            with self._lock:
                return {n: st.config.get("route_prefix")
                        for n, st in self._deployments.items()}
        return None

    def listen_for_change(self, snapshot_ids: Dict[str, int],
                          timeout_s: float = 30.0) -> Dict[str, tuple]:
        """Park until any watched key's version exceeds the caller's
        snapshot; returns {key: (version, value)} ({} on timeout). The
        push half of the reference's LongPollHost (long_poll.py:185) —
        handles/proxies learn of replica-set changes within one notify,
        not one TTL."""
        deadline = time.time() + timeout_s
        with self._change_cv:
            while self._running:
                updates = {}
                for key, ver in snapshot_ids.items():
                    cur = self._versions.get(key, 0)
                    if cur > ver:
                        updates[key] = (cur, self._snapshot(key))
                if updates:
                    return updates
                remaining = deadline - time.time()
                if remaining <= 0:
                    return {}
                self._change_cv.wait(min(remaining, 1.0))
        return {}

    # ------------------------------------------------- death subscription

    def _actor_death_loop(self):
        """Replica liveness from GCS actor events (pubsub), replacing the
        probe-miss heuristic: a death notification prunes + replaces the
        replica on the next reconcile tick, regardless of probe state."""
        import queue as queue_mod

        from ray_tpu_torch.experimental import pubsub

        try:
            self._death_sub = pubsub.subscribe("actor_state")
        except Exception:
            return
        while self._running:
            try:
                msg = self._death_sub.get(timeout=1.0)
            except queue_mod.Empty:
                continue
            except Exception:
                time.sleep(0.5)
                continue
            if not isinstance(msg, dict) or msg.get("state") != "DEAD":
                continue
            aid = msg.get("actor_id")
            changed = []
            with self._lock:
                for name, st in self._deployments.items():
                    for r in list(st.replicas):
                        rid = getattr(r, "_actor_id", None)
                        if rid is not None and rid.hex() == aid:
                            st.replicas.remove(r)
                            changed.append((name, st, r))
            for name, st, r in changed:
                self._note_replica_death(name, st, r)
                self._bump(f"replicas:{name}")
                try:
                    self._scale_to_target(name, st)
                except Exception:
                    pass

    def _note_replica_death(self, name: str, st: _DeploymentState,
                            replica: Any):
        """Fault accounting at death DETECTION (pubsub or probe path):
        starts the time-to-replace clock and counts the restart. If the
        dead replica was itself a pending replacement, its clock is
        dropped — the new spawn measures from THIS death."""
        now = time.monotonic()
        with self._lock:
            self._replacing.pop(id(replica), None)
            st.death_pending.append(now)
            self._fault["restarts"] += 1
        try:
            _fault_metrics()["restarts"].inc(1, {"deployment": name})
        except Exception:
            pass

    # ------------------------------------------------------------- draining

    def _begin_drain(self, name: str, replicas: List[Any]):
        """Rolling-restart path: ask each replica to drain (stop
        admitting, finish in-flight) and park it on the draining list.
        The reconcile loop reaps + kills it when the drain RPC returns
        or the budget expires — deploy()/scale-down never block, and
        stragglers past the budget hand off through the same migration
        path as a crash when the kill lands."""
        from ray_tpu_torch._private.config import config

        timeout_s = float(config.serve_drain_timeout_s)
        now = time.monotonic()
        for r in replicas:
            try:
                ref = r.drain.remote(timeout_s)
            except Exception:
                ref = None
            with self._lock:
                self._draining.append({
                    "name": name, "replica": r, "ref": ref, "start": now,
                    # Grace past the replica-side budget so the RPC
                    # normally returns before the hard deadline fires.
                    "deadline": now + timeout_s + 5.0,
                })

    def _reap_draining(self):
        """Kill drained (or drain-deadline-expired) replicas; observe
        drain duration. Called every reconcile tick — before the
        no-deployments early return, so a deleted deployment's draining
        replicas still get torn down."""
        import ray_tpu_torch

        with self._lock:
            entries = list(self._draining)
        if not entries:
            return
        refs = [e["ref"] for e in entries if e["ref"] is not None]
        ready_set = set()
        if refs:
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0.05)
                ready_set = {id(x) for x in ready}
            except Exception:
                pass
        now = time.monotonic()
        for e in entries:
            if e["ref"] is not None and id(e["ref"]) not in ready_set \
                    and now < e["deadline"]:
                continue
            with self._lock:
                try:
                    self._draining.remove(e)
                except ValueError:
                    continue
            dur = time.monotonic() - e["start"]
            with self._lock:
                self._fault["drain_duration_s"].append(dur)
            try:
                _fault_metrics()["drain"].observe(
                    dur, {"deployment": e["name"]})
            except Exception:
                pass
            self._kill_replicas([e["replica"]])

    def fault_stats(self) -> Dict[str, Any]:
        """Fault-tolerance observability for the chaos bench: restart
        count, per-replacement time-to-replace samples, per-replica
        drain durations, and how many replicas are currently
        draining."""
        with self._lock:
            return {
                "replica_restarts_total": int(self._fault["restarts"]),
                "time_to_replace_s": list(
                    self._fault["time_to_replace_s"]),
                "drain_duration_s": list(
                    self._fault["drain_duration_s"]),
                "draining": len(self._draining),
            }

    # ----------------------------------------------------------- deploy API

    def deploy(self, config: dict, callable_blob: bytes, init_args,
               init_kwargs) -> bool:
        name = config["name"]
        with self._lock:
            existing = self._deployments.get(name)
            st = _DeploymentState(config, callable_blob, init_args,
                                  init_kwargs)
            self._deployments[name] = st
        # Rolling restart: spawn the NEW generation first, repoint the
        # long-poll channel at it, and only then drain the old replicas
        # — their in-flight requests finish (or hand off through the
        # crash-migration path when the drain budget expires) while new
        # traffic already lands on the replacement generation.
        self._scale_to_target(name, st)
        self._bump(f"replicas:{name}")
        self._bump("routes")
        if existing is not None:
            self._begin_drain(name, existing.replicas)
        return True

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            st = self._deployments.pop(name, None)
        if st is not None:
            self._kill_replicas(st.replicas)
        self._bump(f"replicas:{name}")
        self._bump("routes")
        return True

    def get_replicas(self, name: str) -> List[Any]:
        with self._lock:
            st = self._deployments.get(name)
            return list(st.replicas) if st else []

    def get_deployment_info(self, name: str) -> Optional[dict]:
        with self._lock:
            st = self._deployments.get(name)
            if st is None:
                return None
            return {"config": st.config, "num_replicas": len(st.replicas)}

    def list_deployments(self) -> Dict[str, dict]:
        with self._lock:
            return {n: {"config": st.config,
                        "num_replicas": len(st.replicas),
                        "target": st.target}
                    for n, st in self._deployments.items()}

    def shutdown(self) -> bool:
        import ray_tpu_torch

        self._running = False
        with self._change_cv:
            self._change_cv.notify_all()
        with self._lock:
            for st in self._deployments.values():
                self._kill_replicas(st.replicas)
            self._deployments.clear()
            self._kill_replicas([e["replica"] for e in self._draining])
            self._draining.clear()
            proxies = [info["actor"] for info in self._proxies.values()]
            self._proxies.clear()
        for p in proxies:
            try:
                ray_tpu_torch.kill(p)
            except Exception:
                pass
        return True

    # ------------------------------------------------------------ reconcile

    def _reconcile_loop(self):
        while self._running:
            try:
                self._control_cycle()
            except Exception:
                pass
            time.sleep(_RECONCILE_PERIOD_S)

    def _control_cycle(self):
        """One sweep: probe all replicas IN PARALLEL once, then prune /
        autoscale / scale from that single snapshot (a dead replica must
        not stall the loop — probes are bounded by one wait, not one
        blocking get per replica)."""
        import ray_tpu_torch

        # Ingress tracks cluster membership: new nodes get a proxy,
        # dead nodes' entries drop (reference: HTTPState.update).
        try:
            self._reconcile_proxies()
        except Exception:
            pass
        try:
            self._reap_draining()
        except Exception:
            pass
        with self._lock:
            items = list(self._deployments.items())
        if not items:
            return
        probes = []  # (st, replica, ref)
        for _, st in items:
            for r in list(st.replicas):
                try:
                    probes.append((st, r, r.stats.remote()))
                except Exception:
                    probes.append((st, r, None))
        refs = [ref for *_, ref in probes if ref is not None]
        ready_set = set()
        if refs:
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                    timeout=_STATS_TIMEOUT_S)
            ready_set = {id(r) for r in ready}

        stats_by_replica: Dict[int, dict] = {}
        for st, r, ref in probes:
            key = id(r)
            dead = False
            if ref is not None and id(ref) in ready_set:
                try:
                    stats_by_replica[key] = ray_tpu_torch.get(ref,
                                                              timeout=1)
                    self._miss_counts.pop(key, None)
                    self._dead_counts.pop(key, None)
                    # First successful probe of a replacement replica
                    # closes the time-to-replace clock opened at its
                    # predecessor's death detection.
                    with self._lock:
                        pending = self._replacing.pop(key, None)
                    if pending is not None:
                        dep_name, death_ts = pending
                        dt = time.monotonic() - death_ts
                        with self._lock:
                            self._fault["time_to_replace_s"].append(dt)
                        try:
                            _fault_metrics()["replace"].observe(
                                dt, {"deployment": dep_name})
                        except Exception:
                            pass
                    continue
                except (ray_tpu_torch.exceptions.RayActorError,
                        ray_tpu_torch.exceptions.WorkerCrashedError):
                    # Replica-process death. One error can be a transient
                    # routing artifact (e.g. a probe rerouted while the
                    # actor was still registering), so replace only after
                    # two CONSECUTIVE death results — still ~2 cycles,
                    # not 30 miss counts.
                    self._dead_counts[key] = \
                        self._dead_counts.get(key, 0) + 1
                    dead = self._dead_counts[key] >= 2
                except Exception:
                    pass
            # Missed probe: a busy replica (long user request) also misses —
            # only replace after sustained misses, and KILL the old actor so
            # a merely-slow replica can't leak and double capacity.
            self._miss_counts[key] = self._miss_counts.get(key, 0) + 1
            if dead or self._miss_counts[key] >= _MAX_PROBE_MISSES:
                self._miss_counts.pop(key, None)
                self._dead_counts.pop(key, None)
                removed = False
                with self._lock:
                    if r in st.replicas:
                        st.replicas.remove(r)
                        removed = True
                if removed:
                    self._note_replica_death(st.config["name"], st, r)
                    self._bump(f"replicas:{st.config['name']}")
                self._kill_replicas([r])

        now = time.time()
        for name, st in items:
            self._push_replica_stats(name, st, stats_by_replica)
            self._autoscale_one(st, stats_by_replica, now)
            self._scale_to_target(name, st)

    def _push_replica_stats(self, name: str, st: _DeploymentState,
                            stats_by_replica: Dict[int, dict]):
        """Piggyback observed per-replica load on the replicas long-poll
        channel (bumped only on change, so an idle cluster stays quiet) —
        handles route on these pushes instead of issuing two stats RPCs
        per request."""
        with self._lock:
            replicas = list(st.replicas)
        loads = {}
        for r in replicas:
            s = stats_by_replica.get(id(r))
            if s is None:
                continue
            aid = getattr(r, "_actor_id", None)
            key = aid.hex() if aid is not None else str(id(r))
            loads[key] = _load_from_stats(s)
        with self._lock:
            changed = loads != st.pushed_stats
            if changed:
                st.pushed_stats = loads
        if changed:
            self._bump(f"replicas:{name}")

    def _autoscale_one(self, st: _DeploymentState,
                       stats_by_replica: Dict[int, dict], now: float):
        """Queue-depth policy with look-back smoothing (reference:
        autoscaling_policy.py:54-70): desired =
        ceil(avg_ongoing_over_window / target_ongoing_requests), where the
        average spans look_back_period_s of samples — instantaneous spikes
        or dips can't flap the replica count."""
        import math

        ac = st.config.get("autoscaling_config")
        with self._lock:
            replicas = list(st.replicas)
        if not ac or not replicas:
            return
        stats = [stats_by_replica[id(r)] for r in replicas
                 if id(r) in stats_by_replica]
        if not stats:
            return
        sample = sum(_load_from_stats(s) for s in stats)
        window = float(ac.get("look_back_period_s") or 0.0)
        with self._lock:
            st.ongoing_history.append((now, sample))
            st.ongoing_history = [(t, v) for t, v in st.ongoing_history
                                  if now - t <= max(window, 0.0)]
            vals = [v for _, v in st.ongoing_history]
        ongoing = sum(vals) / len(vals) if vals else sample
        desired = math.ceil(ongoing / ac["target_ongoing_requests"]) \
            if ongoing else ac["min_replicas"]
        desired = min(max(desired, ac["min_replicas"]), ac["max_replicas"])
        with self._lock:
            if desired > st.target and \
                    now - st.last_scale_ts >= ac["upscale_delay_s"]:
                st.target, st.last_scale_ts = desired, now
            elif desired < st.target and \
                    now - st.last_scale_ts >= ac["downscale_delay_s"]:
                st.target, st.last_scale_ts = desired, now

    def _scale_to_target(self, name: str, st: _DeploymentState):
        import ray_tpu_torch
        from ray_tpu_torch.serve.replica import Replica

        with self._lock:
            deficit = st.target - len(st.replicas) - st.spawning
            if deficit > 0:
                st.spawning += deficit
        cls = ray_tpu_torch.remote(Replica)
        opts = dict(st.config.get("ray_actor_options") or {})
        # Replicas serve concurrent requests up to max_ongoing_requests
        # (reference: DeploymentConfig.max_concurrent_queries → replica
        # concurrency); without this, ongoing stats would always read 0
        # and queue-depth autoscaling could never trigger.
        opts.setdefault("max_concurrency",
                        st.config.get("max_ongoing_requests") or 100)
        spawned = 0
        try:
            for _ in range(max(0, deficit)):
                rid = f"{name}#{uuid.uuid4().hex[:6]}"
                handle = cls.options(**opts).remote(
                    st.blob, st.init_args, st.init_kwargs, name, rid,
                    user_config=st.config.get("user_config"))
                with self._lock:
                    spawned += 1
                    st.spawning -= 1
                    st.replicas.append(handle)
                    if st.death_pending:
                        # This spawn replaces a detected death: its first
                        # successful stats probe closes the clock.
                        self._replacing[id(handle)] = (
                            name, st.death_pending.pop(0))
        finally:
            if deficit > spawned:
                with self._lock:
                    st.spawning -= deficit - spawned
        if deficit < 0:
            with self._lock:
                extra, st.replicas = (st.replicas[st.target:],
                                      st.replicas[:st.target])
            # Scale-down reuses the rolling-restart path: drain, then
            # kill on reap — in-flight work finishes or migrates.
            self._begin_drain(name, extra)
        if deficit:
            self._bump(f"replicas:{name}")

    @staticmethod
    def _kill_replicas(replicas):
        import ray_tpu_torch

        for r in replicas:
            try:
                ray_tpu_torch.kill(r)
            except Exception:
                pass

    # ----------------------------------------------------------- HTTP proxy

    def _start_proxy(self, port: int):
        """Bring up ingress: one proxy actor PER NODE (reference:
        serve/_private/http_state.py:28 HTTPState — proxy-per-node so
        ingress has no single point of failure and scales with the
        cluster). The head node's proxy gets the configured port; the
        reconcile loop keeps the set in step with cluster membership."""
        self._reconcile_proxies()

    def _reconcile_proxies(self):
        import ray_tpu_torch
        from ray_tpu_torch.serve.ingress import HTTPProxy

        if self._http_port is None:
            return
        try:
            nodes = ray_tpu_torch.nodes()
        except Exception:
            return
        alive = {n["NodeID"]: n for n in nodes if n.get("Alive", True)}
        now = time.time()
        with self._lock:
            # Drop proxies whose node died (their actor died with it).
            for nid in list(self._proxies):
                if nid not in alive:
                    self._proxies.pop(nid, None)
            missing = [nid for nid in alive
                       if nid not in self._proxies
                       and nid not in self._proxy_starting
                       and self._proxy_backoff.get(nid, 0) <= now]
            self._proxy_starting.update(missing)
        cls = ray_tpu_torch.remote(HTTPProxy)
        try:
            for nid in missing:
                self._start_node_proxy(cls, nid)
        finally:
            with self._lock:
                self._proxy_starting.difference_update(missing)

    def _start_node_proxy(self, cls, nid: str) -> None:
        """Start the proxy of node ``nid``, which the caller has claimed
        in ``_proxy_starting``, and record it, or back the node off."""
        import ray_tpu_torch
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        actor = None
        try:
            # Head node keeps the configured port (back-compat for
            # clients of proxy_port()); other nodes request the same
            # port — on a multi-host cluster it binds cleanly, on a
            # single-host test cluster the proxy falls back to an
            # ephemeral port discovered via bound_port().
            actor = cls.options(
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=nid, soft=True)).remote(
                self._http_port, system_config=self._system_config)
            # 30 s, not the reference's 10: a worker of the port's
            # runtime may import torch first (5.6 s on the card's host).
            port = ray_tpu_torch.get(actor.bound_port.remote(),
                                     timeout=30)
        except Exception:
            # Don't leak the half-started actor or hammer an
            # unhealthy node every reconcile tick.
            if actor is not None:
                try:
                    ray_tpu_torch.kill(actor)
                except Exception:
                    pass
            with self._lock:
                self._proxy_backoff[nid] = time.time() + 15.0
            return
        with self._lock:
            self._proxies[nid] = {"actor": actor, "port": port}
            self._proxy_backoff.pop(nid, None)

    def proxy_port(self) -> Optional[int]:
        return self._http_port

    def proxy_addresses(self) -> Dict[str, int]:
        """{node_id: bound_port} of every live ingress proxy."""
        with self._lock:
            return {nid: info["port"]
                    for nid, info in self._proxies.items()}

    def ingress_stats(self) -> Dict[str, Dict[str, Any]]:
        """{node_id: that proxy's ``ingress_stats()``}: admitted, shed,
        in flight and waiting, for a caller that holds no proxy handle."""
        import ray_tpu_torch

        with self._lock:
            proxies = {nid: info["actor"]
                       for nid, info in self._proxies.items()}
        refs = {nid: a.ingress_stats.remote() for nid, a in proxies.items()}
        return {nid: ray_tpu_torch.get(ref, timeout=_STATS_TIMEOUT_S * 5)
                for nid, ref in refs.items()}
