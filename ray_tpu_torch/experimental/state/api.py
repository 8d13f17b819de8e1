"""State API functions — thin typed reads over the port's GCS tables
(the counterpart of ``ray_tpu/experimental/state/api.py``; reference:
``experimental/state/api.py``; server side ``state_aggregator.py:134``
fans out to GCS/raylets, here the GCS is the single source of truth).
``profile`` samples through the port's ``_private/profiler.py``: each
window starts a sampler and stops it (the reference's always-on mode is
not ported)."""

from __future__ import annotations

from typing import Any, Dict, List, Optional

from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch._private.config import config as _cfg


def _gcs():
    return worker_mod.require_worker().gcs


def list_tasks(limit: int = 1000) -> List[Dict[str, Any]]:
    return _gcs().request("list_tasks", {"limit": limit})


def list_actors(limit: int = 1000) -> List[Dict[str, Any]]:
    out = []
    for a in _gcs().request("list_actors")[:limit]:
        a = dict(a)
        aid = a.get("actor_id")
        if hasattr(aid, "hex"):
            a["actor_id"] = aid.hex()
        out.append(a)
    return out


def list_nodes(limit: int = 1000) -> List[Dict[str, Any]]:
    return _gcs().request("nodes")[:limit]


def list_objects(limit: int = 1000) -> List[Dict[str, Any]]:
    return _gcs().request("list_objects", {"limit": limit})


def list_placement_groups(limit: int = 1000) -> List[Dict[str, Any]]:
    table = _gcs().request("pg_table", {})
    if isinstance(table, dict):
        table = list(table.values()) if table else []
    return table[:limit]


def list_jobs(limit: int = 1000) -> List[Dict[str, Any]]:
    return _gcs().request("list_jobs")[:limit]


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    return _gcs().request("summarize_tasks")


def get_actor(actor_id_hex: str) -> Optional[Dict[str, Any]]:
    """The actor's entry, found in the whole table (``list_actors`` stops
    at its ``limit``)."""
    for a in _gcs().request("list_actors"):
        aid = a.get("actor_id")
        if (aid.hex() if hasattr(aid, "hex") else aid) == actor_id_hex:
            return dict(a, actor_id=actor_id_hex)
    return None


# ------------------------------------------------- per-node agent views
# (reference: experimental/state log/stack APIs backed by the per-node
# dashboard agents; here the GCS fans in for us)


def list_logs(node_id: Optional[str] = None) -> List[Dict[str, Any]]:
    """Per-node listing of workers with log files (alive and dead)."""
    payload: Dict[str, Any] = {"list": True}
    if node_id:
        payload["node_id"] = node_id
    return _gcs().request("agent_logs", payload, timeout=30)


def get_log(worker_id: Optional[str] = None,
            actor_id: Optional[str] = None,
            ident: Optional[str] = None,
            stream: Optional[str] = None,
            lines: int = 100,
            follow: bool = False,
            interval_s: Optional[float] = None):
    """Tail matching workers' stdout/stderr cluster-wide. Ids match on
    hex prefixes; ``ident`` matches worker OR actor id. Returns one
    entry per (worker, stream) with the last ``lines`` lines.

    ``follow=True`` returns a GENERATOR with ``tail -f`` semantics
    instead: it yields the initial tail entries, then polls the agents
    every ``interval_s`` (default ``log_follow_interval_s``) with
    byte-offset cursors and yields only entries that gained lines.
    Close the generator (or Ctrl-C the loop consuming it) to stop."""
    payload: Dict[str, Any] = {"lines": lines}
    if worker_id:
        payload["worker_id"] = worker_id
    if actor_id:
        payload["actor_id"] = actor_id
    if ident:
        payload["id"] = ident
    if stream:
        payload["stream"] = stream
    if follow:
        return _follow_log(payload, interval_s)
    out: List[Dict[str, Any]] = []
    for node in _gcs().request("agent_logs", payload, timeout=30):
        if isinstance(node, list):
            out.extend(node)
        elif isinstance(node, dict) and node.get("error"):
            out.append(node)
    return out


def _follow_log(payload: Dict[str, Any], interval_s: Optional[float]):
    """The ``get_log(follow=True)`` generator body: a bounded poll loop
    over the agents' ``agent_logs`` path, cursored by byte offsets keyed
    on each node-local log path so no line is yielded twice and a poll
    reads only what is new."""
    import time as _time

    if interval_s is None:
        interval_s = float(_cfg.log_follow_interval_s)
    interval_s = max(0.05, float(interval_s))
    # cursor key: (node_id, path) -> next byte offset
    cursors: Dict[Any, int] = {}

    def _entries(p) -> List[Dict[str, Any]]:
        out = []
        for node in _gcs().request("agent_logs", p, timeout=30):
            if isinstance(node, list):
                out.extend(node)
        return out

    for e in _entries(payload):
        if e.get("path"):
            cursors[(e["node_id"], e["path"])] = int(
                e.get("next_offset") or 0)
        yield e
    base = {k: v for k, v in payload.items() if k != "lines"}
    while True:
        _time.sleep(interval_s)
        # Agents pick the paths they own out of the merged offset map;
        # unseen paths (new workers) start from byte 0.
        offs = {path: off for (_nid, path), off in cursors.items()}
        for e in _entries({**base, "offsets": offs}):
            if e.get("path"):
                cursors[(e["node_id"], e["path"])] = int(
                    e.get("next_offset") or 0)
            if e.get("lines"):
                yield e


def profile(duration_s: float = 5.0,
            hz: Optional[float] = None,
            mode: str = "wall",
            node_id: Optional[str] = None,
            worker_id: Optional[str] = None,
            actor_id: Optional[str] = None,
            driver: bool = False,
            gcs: bool = False) -> List[Dict[str, Any]]:
    """Cluster-wide sampling profile (the programmatic face of
    ``ray_tpu_torch profile``): one bounded window across every process —
    workers, drivers, node managers, the GCS — returned as a flat list
    of per-process profiles (folded stacks + sample counts). Render
    with ``ray_tpu_torch._private.profiler.folded_lines`` /
    ``speedscope_document``."""
    payload: Dict[str, Any] = {"duration_s": duration_s, "mode": mode}
    if hz:
        payload["hz"] = hz
    if node_id:
        payload["node_id"] = node_id
    if worker_id:
        payload["worker_id"] = worker_id
    if actor_id:
        payload["actor_id"] = actor_id
    if driver:
        payload["driver"] = True
    if gcs:
        payload["gcs"] = True
    # 3x: in-process clusters share one profiler between GCS/NM/driver
    # and their self-windows serialize (the GCS fan-in budgets match).
    return _gcs().request("profile", payload,
                          timeout=3.0 * float(duration_s) + 30.0)


def dump_stacks(node_id: Optional[str] = None,
                timeout_s: float = 5.0) -> List[Dict[str, Any]]:
    """In-band cluster-wide stack capture: every worker's
    ``sys._current_frames()`` as data, one dict per node (the
    programmatic face of ``ray_tpu_torch stack``)."""
    payload: Dict[str, Any] = {"timeout_s": timeout_s}
    if node_id:
        payload["node_id"] = node_id
    return _gcs().request("collect_stacks", payload,
                          timeout=timeout_s + 15)
