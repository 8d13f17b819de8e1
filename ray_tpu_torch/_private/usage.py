"""Usage-stats collection (reference: python/ray/_private/usage/usage_lib.py
— opt-out telemetry recording which libraries / cluster shapes are in use;
architecture comment usage_lib.py:20-28).

Privacy-first divergence from the reference: this implementation NEVER
makes a network call. Stats are aggregated in the GCS KV (``usage`` keys)
and written at driver disconnect to
``<tmp>/ray_tpu_torch/usage_stats_<session_name>.json`` (next to — not inside —
the session dir, which is removed at shutdown) so operators can inspect
or export them by their own means. Opt out with
``RAY_TPU_TORCH_USAGE_STATS_ENABLED=0``.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Dict, Optional, Set

logger = logging.getLogger(__name__)

_KV_NS = "usage"
_lock = threading.Lock()
# Recorded before a driver connects; flushed to the GCS KV at connect time.
_pending_libraries: Set[str] = set()
_pending_features: Dict[str, str] = {}


def usage_stats_enabled() -> bool:
    from ray_tpu_torch._private.config import config

    # refresh: the opt-out env is documented to work whenever it is set,
    # including programmatically between import and the first report.
    return bool(config.refresh_from_env("usage_stats_enabled"))


def _kv():
    from ray_tpu_torch._private import worker as worker_mod
    w = worker_mod.global_worker()
    if w is None:
        return None
    try:
        return w.kv()
    except AttributeError:
        return None


def record_library_usage(name: str) -> None:
    """Called at import time by train/tune/serve/data/rllib/workflow."""
    if not usage_stats_enabled():
        return
    with _lock:
        _pending_libraries.add(name)
    _flush_locked_safe()


def record_extra_usage_tag(key: str, value: str) -> None:
    """Feature-level tag (reference: TagKey in usage_lib)."""
    if not usage_stats_enabled():
        return
    with _lock:
        _pending_features[key] = value
    _flush_locked_safe()


def _flush_locked_safe() -> None:
    """Best-effort push of pending records into the GCS KV; entries that
    reach the KV are dropped from the pending set so re-flushes are
    incremental, not O(all records ever)."""
    if not usage_stats_enabled():
        return
    kv = _kv()
    if kv is None:
        return
    try:
        with _lock:
            libs = list(_pending_libraries)
            feats = dict(_pending_features)
        for lib in libs:
            kv.put(f"lib:{lib}".encode(), b"1", namespace=_KV_NS)
        for k, v in feats.items():
            kv.put(f"tag:{k}".encode(), v.encode(), namespace=_KV_NS)
        with _lock:
            _pending_libraries.difference_update(libs)
            for k, v in feats.items():
                if _pending_features.get(k) == v:
                    del _pending_features[k]
    except Exception:
        pass  # usage stats must never break the app


def on_driver_connect() -> None:
    """Flush records made before init(); called from worker connect."""
    _flush_locked_safe()


def on_driver_disconnect() -> None:
    """Write the local usage report at shutdown (the documented artifact).

    The local cluster's session dir is rmtree'd moments later in the same
    shutdown() call, so the report goes NEXT TO it — a per-session filename
    that survives cleanup and can't be clobbered by concurrent drivers.
    Remote-cluster drivers (no local session dir) fall back to a per-pid
    temp file for the same no-clobber reason.

    The report reads the GCS's KV. A driver whose GCS does not answer one
    bounded dial skips it: each read would redial the dead GCS for the
    whole ``gcs_rpc_timeout_s`` window (60 s) before failing, and the
    report is best-effort.
    """
    try:
        from ray_tpu_torch._private import worker as worker_mod
        w = worker_mod.global_worker()
        if w is None:
            return
        if not w.gcs.reachable():
            logger.debug("usage report skipped: the GCS does not answer")
            return
        cluster = getattr(worker_mod, "_global_cluster", None)
        session_dir = getattr(cluster, "session_dir", None)
        if session_dir:
            path = os.path.join(
                os.path.dirname(session_dir),
                f"usage_stats_{os.path.basename(session_dir)}.json")
        else:
            path = None
        write_usage_report(report_path=path)
    except Exception:
        logger.debug("usage report failed", exc_info=True)


def get_usage_stats() -> Optional[dict]:
    """Aggregate cluster usage snapshot from the GCS KV."""
    kv = _kv()
    if kv is None:
        return None
    try:
        import ray_tpu_torch
        from ray_tpu_torch.version import __version__
        libs, tags = [], {}
        for key in kv.keys(namespace=_KV_NS):
            k = key.decode()
            if k.startswith("lib:"):
                libs.append(k[4:])
            elif k.startswith("tag:"):
                val = kv.get(key, namespace=_KV_NS)
                tags[k[4:]] = val.decode() if val else ""
        return {
            "schema_version": "0.1",
            "ray_tpu_version": __version__,
            "collected_at": time.time(),
            "libraries_used": sorted(libs),
            "extra_tags": tags,
            "total_num_nodes": len(ray_tpu_torch.nodes())
            if ray_tpu_torch.is_initialized() else None,
            "cluster_resources": ray_tpu_torch.cluster_resources()
            if ray_tpu_torch.is_initialized() else None,
        }
    except Exception:
        return None


def write_usage_report(session_dir: Optional[str] = None,
                       report_path: Optional[str] = None) -> Optional[str]:
    """Write the snapshot to a local JSON file (no egress).

    ``report_path`` wins if given; else ``session_dir/usage_stats.json``
    (mid-run operator export); else a per-pid temp file so concurrent
    drivers in a shared tmp never clobber each other.
    """
    if not usage_stats_enabled():
        return None
    stats = get_usage_stats()
    if stats is None:
        return None
    if report_path:
        path = report_path
    elif session_dir:
        path = os.path.join(session_dir, "usage_stats.json")
    else:
        path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                            f"usage_stats_{os.getpid()}.json")
    try:
        with open(path, "w") as f:
            json.dump(stats, f, indent=2)
        return path
    except OSError:
        return None
