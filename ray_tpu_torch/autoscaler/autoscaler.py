"""StandardAutoscaler (port of ``ray_tpu/autoscaler/autoscaler.py``;
reference: ``autoscaler/_private/autoscaler.py:168``
update loop; bin-packing ``resource_demand_scheduler.py:103,171``;
``Monitor`` head daemon ``_private/monitor.py:126`` — here ``run_once``
is callable directly or looped in a thread).

Cycle: read unplaceable demand from the GCS → bin-pack onto configured
node types (first-fit decreasing) respecting ``max_workers`` → launch via
the provider → terminate nodes idle past ``idle_timeout_s``. Node types
carry whole GPUs (``"GPU"``) where the reference's carry TPU chips.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

logger = logging.getLogger("ray_tpu_torch.autoscaler")


@dataclasses.dataclass
class NodeType:
    name: str
    resources: Dict[str, float]         # what a launched node provides
    min_workers: int = 0
    max_workers: int = 10


@dataclasses.dataclass
class AutoscalerConfig:
    node_types: List[NodeType]
    max_workers: int = 10               # across all types (head excluded)
    idle_timeout_s: float = 60.0
    update_interval_s: float = 1.0
    # Grace before a launched node that never registered (or whose GCS
    # entry died) is terminated as failed — a leaked cloud instance
    # otherwise bills forever and pollutes capacity counts.
    boot_grace_s: float = 60.0


class StandardAutoscaler:
    def __init__(self, gcs_conn, provider: NodeProvider,
                 config: AutoscalerConfig):
        """``gcs_conn``: a protocol.Conn to the GCS (the head worker's
        ``.gcs`` works)."""
        self.gcs = gcs_conn
        self.provider = provider
        self.config = config
        self._idle_since: Dict[str, float] = {}
        self._first_seen: Dict[str, float] = {}
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --------------------------------------------------------------- loop

    def start(self):
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="rtpu-autoscaler")
        self._thread.start()

    def stop(self):
        self._stop.set()

    def _loop(self):
        while not self._stop.wait(self.config.update_interval_s):
            try:
                self.run_once()
            except Exception:
                logger.exception("autoscaler update failed")

    # -------------------------------------------------------------- cycle

    def run_once(self) -> Dict[str, Any]:
        """One reconcile pass; returns a summary (for tests/monitoring)."""
        demand = self.gcs.request("pending_demand")
        requests: List[Dict[str, float]] = list(demand["tasks"])
        for bundles in demand["pg_bundles"]:
            requests.extend(bundles)

        launched = self._scale_up(requests)
        terminated = self._scale_down()
        return {"demand": len(requests), "launched": launched,
                "terminated": terminated}

    def _count_by_type(self) -> Dict[str, int]:
        counts: Dict[str, int] = {}
        for nid in self.provider.non_terminated_nodes():
            t = self.provider.node_tags(nid).get("node-type", "?")
            counts[t] = counts.get(t, 0) + 1
        return counts

    def _scale_up(self, requests: List[Dict[str, float]]) -> int:
        """First-fit-decreasing bin-packing of unplaceable requests onto
        hypothetical new nodes (reference:
        resource_demand_scheduler.get_nodes_to_launch :171)."""
        if not requests:
            return self._ensure_min_workers()
        counts = self._count_by_type()
        total = sum(counts.values())

        # sort demands largest-first for FFD
        def size(r):
            return sum(r.values())

        pending = sorted(requests, key=size, reverse=True)
        to_launch: Dict[str, int] = {}
        open_bins: List[Dict[str, float]] = []  # remaining capacity

        for req in pending:
            placed = False
            for cap in open_bins:
                if all(cap.get(k, 0) >= v for k, v in req.items()):
                    for k, v in req.items():
                        cap[k] = cap.get(k, 0) - v
                    placed = True
                    break
            if placed:
                continue
            # open a new bin: first node type that fits the request
            for nt in self.config.node_types:
                fits = all(nt.resources.get(k, 0) >= v
                           for k, v in req.items())
                cur = counts.get(nt.name, 0) + to_launch.get(nt.name, 0)
                if fits and cur < nt.max_workers and \
                        total + sum(to_launch.values()) < \
                        self.config.max_workers:
                    to_launch[nt.name] = to_launch.get(nt.name, 0) + 1
                    cap = dict(nt.resources)
                    for k, v in req.items():
                        cap[k] = cap.get(k, 0) - v
                    open_bins.append(cap)
                    break
            # unfittable requests are skipped (reported via demand count)

        launched = 0
        for nt in self.config.node_types:
            n = to_launch.get(nt.name, 0)
            if n:
                self.provider.create_node(nt.name, dict(nt.resources), n)
                launched += n
        return launched + self._ensure_min_workers()

    def _ensure_min_workers(self) -> int:
        counts = self._count_by_type()
        launched = 0
        for nt in self.config.node_types:
            deficit = nt.min_workers - counts.get(nt.name, 0)
            if deficit > 0:
                self.provider.create_node(nt.name, dict(nt.resources),
                                          deficit)
                launched += deficit
        return launched

    def _scale_down(self) -> int:
        """Terminate nodes fully idle longer than idle_timeout_s
        (reference: autoscaler.py idle node termination via
        last_used_time)."""
        nodes = {n["NodeID"]: n for n in self.gcs.request("nodes")}
        now = time.time()
        terminated = 0
        counts = self._count_by_type()
        live = set(self.provider.non_terminated_nodes())
        for gone in set(self._first_seen) - live:
            self._first_seen.pop(gone, None)
            self._idle_since.pop(gone, None)
        for nid in live:
            tags = self.provider.node_tags(nid)
            nt_name = tags.get("node-type", "?")
            nt = next((t for t in self.config.node_types
                       if t.name == nt_name), None)
            first = self._first_seen.setdefault(nid, now)
            # A provider node may be ONE GCS node (tag "gcs-node-id") or a
            # whole GPU host pool — several hosts sharing a "slice" label
            # (gpu_pool_provider): pool idleness is judged across ALL its
            # hosts, and termination is always pool-atomic.
            gcs_id = tags.get("gcs-node-id")
            if gcs_id:
                infos = [nodes.get(gcs_id)]
            elif tags.get("slice"):
                infos = [n for n in nodes.values()
                         if n.get("Labels", {}).get("slice")
                         == tags["slice"]]
            else:
                infos = []
            alive_infos = [i for i in infos if i and i["Alive"]]
            if not alive_infos:
                # A queued-resources request still WAITING_FOR_RESOURCES
                # has no hosts yet and may wait arbitrarily long for
                # cloud capacity — not a boot failure.
                if tags.get("state") == "WAITING_FOR_RESOURCES":
                    self._first_seen[nid] = now
                    continue
                # Never registered (still booting?) or died: terminate once
                # the boot grace expires so the instance doesn't leak.
                if now - first >= self.config.boot_grace_s:
                    logger.warning(
                        "terminating failed node %s (no live GCS entry)",
                        nid)
                    self.provider.terminate_node(nid)
                    self._first_seen.pop(nid, None)
                    counts[nt_name] = counts.get(nt_name, 1) - 1
                    terminated += 1
                continue
            idle = all(i["Resources"] == i["Available"]
                       for i in alive_infos)
            if not idle:
                self._idle_since.pop(nid, None)
                continue
            since = self._idle_since.setdefault(nid, now)
            if now - since >= self.config.idle_timeout_s:
                if nt and counts.get(nt_name, 0) <= nt.min_workers:
                    continue
                self.provider.terminate_node(nid)
                self._idle_since.pop(nid, None)
                counts[nt_name] = counts.get(nt_name, 1) - 1
                terminated += 1
        return terminated
