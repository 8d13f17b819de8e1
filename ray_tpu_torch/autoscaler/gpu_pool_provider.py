"""GPU host-pool node provider: pools as the unit of scaling (port of
``ray_tpu/autoscaler/tpu_pod_provider.py``, which scales TPU slices).

A pool is a set of GPU hosts that form one NVLink/NVSwitch domain (an
NVL8 box, or a rack-scale NVLink system split into hosts): the GPUs of a
pool talk over NVLink, and GPUs of two pools only over the network. So a
pool is created and deleted as a unit, and a gang should not straddle two.

Role-equivalent to a cloud provider plugin (reference:
``autoscaler/node_provider.py:13`` interface;
``autoscaler/batching_node_provider.py`` — reconcile desired state with
ONE batched cloud call per tick, the shape Kubernetes/queued APIs want).
The cloud surface modeled here is a queued-capacity API, as clouds offer
for GPU capacity blocks: you request a pool SHAPE (e.g. ``h100-80gb`` x
hosts), the request waits in WAITING_FOR_RESOURCES until capacity frees,
then the whole pool becomes ACTIVE at once.

Provider behaviors:
- a provider "node" is a POOL (atomic create/delete; per-host termination
  would cut an NVLink domain);
- hosts of a booted pool register with a ``slice`` label carrying the
  request's name, which the GCS's placement-group scheduler uses for
  pool-affine placement of GPU bundles (gcs.py, slice-affine placement);
- pending (queued-but-not-granted) requests count against max_workers so
  the autoscaler does not pile up duplicate requests while one waits.

``GpuPoolProvider`` talks to a ``cloud`` object with the queued-resource
verbs. ``FakeGpuCloud`` implements them against an in-process
``cluster_utils.Cluster`` (one NodeManager per simulated host, each
declaring its share of the pool's GPUs), so multi-pool scale-up/down is
testable hostless.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider

# Queued-resource states (mirrors the QueuedResources state machine).
QUEUED = "WAITING_FOR_RESOURCES"
ACTIVE = "ACTIVE"
DELETING = "DELETING"


class GpuPoolCloud:
    """The queued-resources verbs a real backend implements (a cloud's
    GPU capacity API). Methods are batched per reconcile tick."""

    def create_queued_resources(self, requests: List[dict]) -> None:
        raise NotImplementedError

    def delete_queued_resources(self, names: List[str]) -> None:
        raise NotImplementedError

    def list_queued_resources(self) -> Dict[str, dict]:
        """name -> {"state": ..., "node_type": ...}"""
        raise NotImplementedError


class GpuPoolProvider(NodeProvider):
    """Pool-granular provider over a queued-resources cloud."""

    def __init__(self, cloud: GpuPoolCloud,
                 provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config)
        self.cloud = cloud
        self._lock = threading.Lock()
        # Desired state: name -> request dict. Reconcile diffs this
        # against the cloud listing with one batch per direction.
        self._desired: Dict[str, dict] = {}
        # Last listing from this tick's reconcile: node_tags/is_running
        # serve from it so an autoscaler tick stays O(1) cloud calls.
        self._listing: Dict[str, dict] = {}

    # ------------------------------------------------------- reconcile

    def _reconcile(self) -> Dict[str, dict]:
        """One batched diff: create missing, delete undesired, return the
        cloud's current view (reference: batching_node_provider's single
        scale_request per update)."""
        listing = self.cloud.list_queued_resources()
        with self._lock:
            to_create = [req for name, req in self._desired.items()
                         if name not in listing]
            to_delete = [name for name in listing
                         if name not in self._desired
                         and listing[name]["state"] != DELETING]
        if to_create:
            self.cloud.create_queued_resources(to_create)
        if to_delete:
            self.cloud.delete_queued_resources(to_delete)
        if to_create or to_delete:
            listing = self.cloud.list_queued_resources()
        with self._lock:
            self._listing = listing
        return listing

    # -------------------------------------------------- provider surface

    def non_terminated_nodes(self) -> List[str]:
        listing = self._reconcile()
        with self._lock:
            return [n for n in self._desired if n in listing
                    and listing[n]["state"] in (QUEUED, ACTIVE)]

    def create_node(self, node_type: str, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        # node_config carries the POOL AGGREGATE (what the bin-packer
        # fits demand against) plus "hosts"; per-host shares derive here.
        hosts = max(1, int(node_config.get("hosts", 1)))
        names = []
        with self._lock:
            for _ in range(count):
                name = f"qr-{node_type}-{uuid.uuid4().hex[:8]}"
                self._desired[name] = {
                    "name": name,
                    "node_type": node_type,
                    "accelerator_type":
                        self.provider_config.get("accelerator_type",
                                                 "h100-80gb"),
                    "hosts": hosts,
                    "gpus_per_host": float(
                        node_config.get("GPU", 0)) / hosts,
                    "cpus_per_host": float(
                        node_config.get("CPU", hosts)) / hosts,
                }
                names.append(name)
        self._reconcile()
        return names

    def terminate_node(self, node_id: str) -> None:
        with self._lock:
            self._desired.pop(node_id, None)
        self._reconcile()

    def node_tags(self, node_id: str) -> Dict[str, str]:
        with self._lock:
            listing = self._listing
        info = listing.get(node_id) or \
            self.cloud.list_queued_resources().get(node_id, {})
        return {"node-type": info.get("node_type", "?"),
                "slice": node_id,
                "state": info.get("state", "?")}

    def is_running(self, node_id: str) -> bool:
        with self._lock:
            listing = dict(self._listing)
        return listing.get(node_id, {}).get("state") == ACTIVE


class FakeGpuCloud(GpuPoolCloud):
    """Queued-resources harness over an in-process cluster.

    Capacity-gated: at most ``capacity_pools`` may be ACTIVE; excess
    requests queue (WAITING_FOR_RESOURCES) and are granted FIFO as
    capacity frees — the property that makes queued-resource autoscaling
    different from instant VMs. Granting a pool boots one in-process
    NodeManager per host, labeled ``slice=<name>`` so the GCS's
    pool-affine PG placement sees real topology.
    """

    def __init__(self, cluster, capacity_pools: int = 2,
                 grant_delay_s: float = 0.0):
        self.cluster = cluster
        self.capacity = capacity_pools
        self.grant_delay_s = grant_delay_s
        self._lock = threading.Lock()
        self._state: Dict[str, dict] = {}   # name -> record
        self._nms: Dict[str, list] = {}     # name -> [NodeManager]

    def create_queued_resources(self, requests: List[dict]) -> None:
        now = time.time()
        with self._lock:
            for req in requests:
                self._state.setdefault(req["name"], {
                    **req, "state": QUEUED, "requested_at": now})
        self._grant()

    def delete_queued_resources(self, names: List[str]) -> None:
        with self._lock:
            nms = [(n, self._nms.pop(n, [])) for n in names]
            for n in names:
                self._state.pop(n, None)
        for _n, managers in nms:
            for nm in managers:
                try:
                    self.cluster.remove_node(nm)
                except Exception:
                    pass
        self._grant()

    def list_queued_resources(self) -> Dict[str, dict]:
        self._grant()
        with self._lock:
            return {n: dict(rec) for n, rec in self._state.items()}

    # ------------------------------------------------------------ grants

    def _grant(self) -> None:
        """FIFO: promote queued requests to ACTIVE while capacity lasts,
        booting one labeled NodeManager per host."""
        to_boot = []
        now = time.time()
        with self._lock:
            active = sum(1 for r in self._state.values()
                         if r["state"] == ACTIVE)
            queued = sorted(
                (r for r in self._state.values() if r["state"] == QUEUED),
                key=lambda r: r["requested_at"])
            for rec in queued:
                if active >= self.capacity:
                    break
                if now - rec["requested_at"] < self.grant_delay_s:
                    continue
                rec["state"] = ACTIVE
                active += 1
                to_boot.append(dict(rec))
        for rec in to_boot:
            managers = []
            for _h in range(rec["hosts"]):
                managers.append(self.cluster.add_node(
                    num_cpus=rec["cpus_per_host"],
                    num_gpus=rec["gpus_per_host"],
                    labels={"slice": rec["name"]},
                ))
            with self._lock:
                if rec["name"] in self._state:
                    self._nms[rec["name"]] = managers
                    managers = None
            if managers is not None:
                # Deleted while booting: tear the phantom hosts down.
                for nm in managers:
                    try:
                        self.cluster.remove_node(nm)
                    except Exception:
                        pass
