"""Multi-node test cluster on one host (port of ``ray_tpu/cluster_utils.py``;
reference: ``python/ray/cluster_utils.py:99`` ``Cluster.add_node`` :165 —
extra raylet+plasma processes on one machine).

``Cluster`` hosts one GCS plus N in-process ``NodeManager`` instances (each
with its own shm object store and worker subprocess pool), so multi-node
scheduling, spillback, autoscaling and failure tests run hostless. A node
declares whole GPUs (``num_gpus``) where the reference's declares TPU
chips; its GPU ids start at 0, as on a host of its own. With
``gcs_out_of_process=True`` (or the config knob) the GCS runs as a real
subprocess and every node manager reaches it purely by address.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional

from ray_tpu_torch._private import protocol
from ray_tpu_torch._private.node_manager import NodeManager


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[dict] = None,
                 gcs_out_of_process: Optional[bool] = None):
        from ray_tpu_torch._private.config import config

        # The port's own session root, as ``init`` keeps it.
        self.session_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch",
            f"cluster_{int(time.time()*1000)}_{os.getpid()}")
        os.makedirs(self.session_dir, exist_ok=True)
        if gcs_out_of_process is None:
            gcs_out_of_process = bool(config.gcs_out_of_process)
        self.gcs = None        # in-process GcsServer, or None
        self.gcs_proc = None   # gcs_launcher.GcsProcess, or None
        self._gcs_probe: Optional[protocol.Conn] = None
        if gcs_out_of_process:
            from ray_tpu_torch._private.gcs_launcher import GcsProcess

            self.gcs_proc = GcsProcess(session_dir=self.session_dir)
            self.address = self.gcs_proc.address
        else:
            from ray_tpu_torch._private.gcs import GcsServer

            self.gcs = GcsServer()
            self.address = self.gcs.address
        self.nodes: List[NodeManager] = []
        if initialize_head:
            self.add_node(is_head=True, **(head_node_args or {}))

    def add_node(self, *, num_cpus: float = 2, num_gpus: float = 0,
                 resources: Optional[Dict[str, float]] = None,
                 object_store_memory: int = 128 * 1024 * 1024,
                 is_head: bool = False,
                 labels: Optional[Dict[str, str]] = None) -> NodeManager:
        nm = NodeManager(
            gcs_address=self.address,
            session_dir=self.session_dir,
            num_cpus=num_cpus,
            num_gpus=num_gpus,
            resources=resources,
            object_store_memory=object_store_memory,
            is_head=is_head and not any(
                n for n in self.nodes),  # only one head
            node_name=f"node{len(self.nodes)}",
            labels=labels,
        )
        self.nodes.append(nm)
        return nm

    def remove_node(self, nm: NodeManager, allow_graceful: bool = True):
        """Tear a node down (the in-process analog of SIGKILLing a raylet;
        reference: cluster_utils.Cluster.remove_node)."""
        if nm in self.nodes:
            self.nodes.remove(nm)
        nm.shutdown()

    def _count_alive(self) -> int:
        """Alive nodes as the GCS sees them, without a driver: peek the
        in-process server's ledger, or ask the subprocess over its own
        probe connection (connect-by-address only — no shortcuts)."""
        if self.gcs is not None:
            with self.gcs._sched_lock:
                return sum(1 for n in self.gcs._nodes.values() if n.alive)
        if self._gcs_probe is None or self._gcs_probe.closed:
            self._gcs_probe = protocol.connect(
                self.address, name="cluster-probe", timeout=10)
        nodes = self._gcs_probe.request("nodes", timeout=10)
        return sum(1 for n in nodes if n["Alive"])

    def wait_for_nodes(self, timeout: float = 30) -> bool:
        """Wait until the GCS sees every added node alive."""
        from ray_tpu_torch._private import worker as worker_mod

        deadline = time.time() + timeout
        while time.time() < deadline:
            w = worker_mod.global_worker()
            try:
                alive = (sum(1 for n in w.nodes() if n["Alive"])
                         if w is not None else self._count_alive())
            except Exception:
                alive = 0
            if alive >= len(self.nodes):
                return True
            time.sleep(0.1)
        return False

    def connect(self, **kwargs):
        """ray_tpu_torch.init against this cluster."""
        import ray_tpu_torch

        return ray_tpu_torch.init(address=self.address, **kwargs)

    def shutdown(self):
        for nm in list(self.nodes):
            try:
                nm.shutdown()
            except Exception:
                pass
        self.nodes.clear()
        if self._gcs_probe is not None:
            try:
                self._gcs_probe.close()
            except Exception:
                pass
            self._gcs_probe = None
        try:
            if self.gcs_proc is not None:
                self.gcs_proc.terminate()
            if self.gcs is not None:
                self.gcs.close()
        except Exception:
            pass
