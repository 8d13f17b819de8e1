"""Cluster pub/sub on the port's runtime (a copy of
``ray_tpu/experimental/pubsub.py``; reference: ``src/ray/pubsub/publisher.h`` /
``subscriber.h`` — the GCS-backed channels carrying actor state, logs,
and error notifications; ``ray._private.gcs_pubsub`` on the Python side).

Channels are plain strings; messages are any picklable value. The GCS
fans published messages out to every subscribed connection as a push.

    from ray_tpu_torch.experimental import pubsub
    sub = pubsub.subscribe("alerts")
    pubsub.publish("alerts", {"sev": 1})
    msg = sub.get(timeout=5)       # -> {"sev": 1}

Built-in channels: ``actor_state`` (lifecycle transitions published by
the GCS actor manager).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch._private import worker as worker_mod

# ``_lock`` guards the subscriptions; the GCS connection's reader thread
# takes it to dispatch a push. ``_gcs_lock`` orders the subscribe and
# unsubscribe requests, and is held across them: a request made under
# ``_lock`` would wait for a reply that only the reader thread can read,
# while the reader waits for ``_lock`` to dispatch a push that came first.
_lock = threading.Lock()
_gcs_lock = threading.Lock()
_queues: Dict[str, list] = {}
_installed = False


class Subscription:
    def __init__(self, channel: str):
        self.channel = channel
        self._q: "queue.Queue" = queue.Queue()

    def get(self, timeout: Optional[float] = None) -> Any:
        """Next message on the channel (blocking; queue.Empty on timeout)."""
        return self._q.get(timeout=timeout)

    def get_nowait(self) -> Any:
        return self._q.get_nowait()

    def unsubscribe(self) -> None:
        with _gcs_lock:
            with _lock:
                subs = _queues.get(self.channel, [])
                if self in subs:
                    subs.remove(self)
                last = not subs and _queues.pop(self.channel, None) is not None
            if last:
                try:
                    worker_mod.require_worker().gcs.request(
                        "unsubscribe", {"channel": self.channel})
                except Exception:
                    pass


def _dispatch(payload: dict) -> None:
    """Called from the worker's GCS push handler."""
    with _lock:
        subs = list(_queues.get(payload.get("channel", ""), ()))
    for s in subs:
        s._q.put(payload.get("message"))


def _install() -> None:
    global _installed
    if _installed:
        return
    worker_mod.register_pubsub_dispatch(_dispatch)
    _installed = True


def subscribe(channel: str) -> Subscription:
    """Subscribe this process to a channel; returns a Subscription whose
    ``get()`` yields messages in publish order."""
    w = worker_mod.require_worker()
    _install()
    sub = Subscription(channel)
    with _gcs_lock:
        with _lock:
            first = channel not in _queues
            _queues.setdefault(channel, []).append(sub)
        if first:
            w.gcs.request("subscribe", {"channel": channel})
    return sub


def publish(channel: str, message: Any) -> None:
    """Publish a message to every subscriber of the channel."""
    worker_mod.require_worker().gcs.notify(
        "publish", {"channel": channel, "message": message})
