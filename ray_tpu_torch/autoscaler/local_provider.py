"""Process-backed node provider (port of
``ray_tpu/autoscaler/local_provider.py``; reference:
``autoscaler/_private/local/node_provider.py`` — the non-cloud provider;
here "launching a node" spawns a real OS process running the node daemon,
so autoscaled nodes have their own worker pools, object stores, and
failure domains).

A node of a type with ``"GPU": N`` declares N GPUs, ids 0..N-1 of the
GPUs its process sees. Each daemon writes the id it registered under to a
file this provider names, and ``node_tags`` reports it as
``gcs-node-id``: the autoscaler then judges the node by its GCS entry
(busy or idle). The reference's provider tags no GCS id, so its
autoscaler finds no entry for a running node and terminates it as failed
once ``boot_grace_s`` has passed, busy or not. A cloud or GPU-pool provider implements the same
``NodeProvider`` surface by replacing the subprocess spawn with an
instance/pool request.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import NodeProvider


class LocalProcessNodeProvider(NodeProvider):
    def __init__(self, gcs_address: str,
                 provider_config: Optional[Dict[str, Any]] = None):
        super().__init__(provider_config)
        self.gcs_address = gcs_address
        self._procs: Dict[str, subprocess.Popen] = {}
        self._tags: Dict[str, Dict[str, str]] = {}
        self._id_dir = tempfile.mkdtemp(prefix="rtt_node_ids_")

    def non_terminated_nodes(self) -> List[str]:
        return [nid for nid, p in self._procs.items() if p.poll() is None]

    def create_node(self, node_type: str, node_config: Dict[str, Any],
                    count: int) -> List[str]:
        out = []
        for _ in range(count):
            nid = f"local-{node_type}-{uuid.uuid4().hex[:8]}"
            resources = {k: v for k, v in node_config.items()
                         if k not in ("CPU", "GPU")}
            cmd = [
                sys.executable, "-m", "ray_tpu_torch.scripts.node_daemon",
                "--gcs-address", self.gcs_address,
                "--num-cpus", str(node_config.get("CPU", 1)),
                "--num-gpus", str(node_config.get("GPU", 0)),
                "--resources", json.dumps(resources),
                "--node-name", nid,
                "--node-id-file", os.path.join(self._id_dir, nid),
            ]
            osm = self.provider_config.get("object_store_memory")
            if osm:
                cmd += ["--object-store-memory", str(osm)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
            self._procs[nid] = proc
            self._tags[nid] = {"node-type": node_type, "pid": str(proc.pid)}
            out.append(nid)
        return out

    def terminate_node(self, node_id: str) -> None:
        proc = self._procs.pop(node_id, None)
        self._tags.pop(node_id, None)
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()

    def node_tags(self, node_id: str) -> Dict[str, str]:
        tags = self._tags.get(node_id, {})
        if tags and "gcs-node-id" not in tags:
            try:
                with open(os.path.join(self._id_dir, node_id)) as f:
                    tags["gcs-node-id"] = f.read().strip()
            except FileNotFoundError:
                pass   # not registered yet: still booting
        return dict(tags)

    def shutdown(self) -> None:
        super().shutdown()
        shutil.rmtree(self._id_dir, ignore_errors=True)
