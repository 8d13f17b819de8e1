"""Standalone worker-node daemon (port of ``ray_tpu/scripts/node_daemon.py``;
reference: ``ray start --address=<head>`` spawning a raylet that joins an
existing cluster, services.py start_raylet). ``--num-gpus N`` declares
GPUs 0..N-1 of the GPUs this process sees.

    python -m ray_tpu_torch.scripts.node_daemon --gcs-address HOST:PORT \
        [--num-cpus N] [--num-gpus N] [--resources '{"k": 1}'] \
        [--object-store-memory BYTES] [--session-dir DIR] \
        [--node-name NAME] [--node-id-file PATH]

Runs a NodeManager until SIGTERM/SIGINT, then tears it down. Once the
node has registered, ``--node-id-file`` receives its GCS node id (the
process provider maps its nodes to GCS entries through it).
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="ray_tpu_torch-node")
    ap.add_argument("--gcs-address", required=True)
    ap.add_argument("--num-cpus", type=float, default=2)
    ap.add_argument("--num-gpus", type=float, default=0)
    ap.add_argument("--resources", default="{}")
    ap.add_argument("--object-store-memory", type=int, default=256 << 20)
    ap.add_argument("--session-dir", default="")
    ap.add_argument("--node-name", default="node")
    ap.add_argument("--node-id-file", default="")
    args = ap.parse_args(argv)

    from ray_tpu_torch._private.node_manager import NodeManager

    session_dir = args.session_dir or os.path.join(
        tempfile.gettempdir(), "ray_tpu_torch",
        f"node_{int(time.time() * 1000)}_{os.getpid()}")
    nm = NodeManager(
        gcs_address=args.gcs_address,
        session_dir=session_dir,
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources=json.loads(args.resources) or None,
        object_store_memory=args.object_store_memory,
        is_head=False,
        node_name=args.node_name,
    )
    print(f"node {nm.node_id[:12]} joined {args.gcs_address}", flush=True)
    if args.node_id_file:
        tmp = args.node_id_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(nm.node_id)
        os.replace(tmp, args.node_id_file)

    stop = {"flag": False}

    def on_term(sig, frame):
        stop["flag"] = True

    signal.signal(signal.SIGTERM, on_term)
    signal.signal(signal.SIGINT, on_term)
    while not stop["flag"] and not nm._shutdown:
        time.sleep(0.2)
    nm.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
