"""Ingress admission control: concurrency budget, shed watermarks,
per-tenant fairness (a copy of ``ray_tpu/serve/ingress/admission.py``).

Everything here runs on the proxy's single asyncio loop — no locks.
The model (reference shape: the serve proxy's request router plus an
envoy-style admission filter):

- A per-proxy **concurrency budget** (``serve_ingress_max_inflight``):
  requests past the front door and not yet answered. Under budget,
  admission is immediate.
- A bounded **waiting room**: arrivals over budget park in per-tenant
  queues served **deficit-round-robin** (every tenant's queue gets
  ``_QUANTUM`` of service credit per dispatch round; unit-cost
  requests make this strict round-robin across tenants, but the
  deficit form keeps the door open for weighted costs). Arrivals that
  would push the waiting room past ``serve_ingress_queue_watermark``
  are SHED immediately — typed ``ServeOverloadedError`` mapping to
  ``429 + Retry-After`` — and a request that waits longer than
  ``serve_ingress_queue_timeout_s`` is shed with 503: the queue bounds
  latency, it does not hide overload.
- An optional per-tenant **token bucket**
  (``serve_ingress_tenant_rate`` / ``_burst``): a single tenant
  flooding the proxy exhausts its own bucket and is shed with the
  time-to-next-token as ``Retry-After``, while other tenants' requests
  keep flowing.
"""

from __future__ import annotations

import asyncio
import collections
import time
from typing import Deque, Dict, Optional, Tuple

from ray_tpu_torch.exceptions import ServeOverloadedError

_QUANTUM = 1.0       # DRR service credit per tenant per round
_COST = 1.0          # unit request cost
_MAX_BUCKETS = 4096  # LRU cap on per-tenant token buckets: the tenant
#                      header is CLIENT-supplied, so without a bound a
#                      unique-tenant-per-request flood grows state
#                      forever (evicting an idle bucket merely regrants
#                      that tenant one fresh burst)


class TokenBucket:
    """Classic token bucket; ``take`` returns (granted, retry_after_s)."""

    def __init__(self, rate: float, burst: float):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self._tokens = self.burst
        self._at = time.monotonic()

    def take(self, n: float = 1.0) -> Tuple[bool, float]:
        now = time.monotonic()
        self._tokens = min(self.burst,
                           self._tokens + (now - self._at) * self.rate)
        self._at = now
        if self._tokens >= n:
            self._tokens -= n
            return True, 0.0
        need = (n - self._tokens) / self.rate if self.rate > 0 else 1.0
        return False, need


class AdmissionController:
    """Single-loop admission state for one ingress proxy."""

    def __init__(self, *, max_inflight: int, queue_watermark: int,
                 queue_timeout_s: float, tenant_rate: float = 0.0,
                 tenant_burst: float = 16.0, metrics=None,
                 tags: Optional[Dict[str, str]] = None):
        self.max_inflight = int(max_inflight)
        self.queue_watermark = int(queue_watermark)
        self.queue_timeout_s = float(queue_timeout_s)
        self.tenant_rate = float(tenant_rate)
        self.tenant_burst = float(tenant_burst)
        self.inflight = 0
        self._waiting = 0
        # DRR state: per-tenant FIFO of futures + service deficits, and
        # a round-robin ring of tenants with queued work.
        self._queues: Dict[str, Deque[asyncio.Future]] = {}
        self._deficit: Dict[str, float] = {}
        self._ring: collections.deque = collections.deque()
        self._buckets: Dict[str, TokenBucket] = {}
        self._m = metrics or {}
        self._tags = dict(tags or {})
        self.shed_total = 0

    # ------------------------------------------------------------ helpers

    def _shed(self, reason: str, retry_after_s: float,
              http_status: int = 429) -> ServeOverloadedError:
        self.shed_total += 1
        if "shed" in self._m:
            self._m["shed"].inc(1, dict(self._tags, reason=reason))
        err = ServeOverloadedError(
            f"ingress overloaded ({reason})",
            retry_after_s=max(0.05, retry_after_s), reason=reason)
        err.http_status = http_status
        return err

    def _publish_inflight(self) -> None:
        if "inflight" in self._m:
            self._m["inflight"].set(self.inflight, self._tags)

    def stats(self) -> Dict[str, float]:
        return {"inflight": self.inflight, "waiting": self._waiting,
                "shed_total": self.shed_total}

    # ----------------------------------------------------------- admission

    async def acquire(self, tenant: str) -> None:
        """Admit or raise ``ServeOverloadedError``. Must be awaited on
        the proxy loop; pair every success with ``release()``."""
        if self.tenant_rate > 0:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= _MAX_BUCKETS:
                    self._buckets.pop(next(iter(self._buckets)))
                bucket = self._buckets[tenant] = TokenBucket(
                    self.tenant_rate, self.tenant_burst)
            else:
                # Move-to-back = LRU order for the eviction above.
                self._buckets.pop(tenant)
                self._buckets[tenant] = bucket
            ok, retry = bucket.take(_COST)
            if not ok:
                raise self._shed("tenant_rate", retry)
        if self.inflight < self.max_inflight and self._waiting == 0:
            self.inflight += 1
            self._publish_inflight()
            return
        if self._waiting >= self.queue_watermark:
            # Watermark shed: hint the client at roughly one queue
            # drain's worth of backoff.
            raise self._shed("queue_watermark",
                             min(self.queue_timeout_s, 1.0))
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        q = self._queues.get(tenant)
        if q is None:
            q = self._queues[tenant] = collections.deque()
            self._deficit.setdefault(tenant, 0.0)
        if not q and tenant not in self._ring:
            self._ring.append(tenant)
        q.append(fut)
        self._waiting += 1
        try:
            await asyncio.wait_for(fut, timeout=self.queue_timeout_s)
        except asyncio.TimeoutError:
            self._ungrant_if_raced(fut)
            raise self._shed("queue_timeout", self.queue_timeout_s,
                             http_status=503) from None
        except asyncio.CancelledError:
            # Handler cancelled (client gone) while parked.
            self._ungrant_if_raced(fut)
            raise
        finally:
            if not fut.done() or fut.cancelled():
                # Timed out / handler cancelled while parked: the slot
                # was never granted; drop our queue entry lazily (the
                # dispatcher skips dead futures).
                self._waiting -= 1
        # Granted by _dispatch (which already took the inflight slot).

    def _ungrant_if_raced(self, fut: asyncio.Future) -> None:
        """A grant can race the timeout/cancel in the same loop tick
        (and on 3.12+ ``wait_for`` re-raises CancelledError even for a
        completed future): the caller is NOT proceeding, so hand the
        granted slot straight back — otherwise it leaks and
        ``max_inflight`` shrinks forever."""
        if fut.done() and not fut.cancelled():
            self.inflight -= 1
            self._dispatch()

    def release(self) -> None:
        self.inflight -= 1
        self._dispatch()
        self._publish_inflight()

    def _dispatch(self) -> None:
        """Hand freed slots to waiters, deficit-round-robin across
        tenants with queued work."""
        while self.inflight < self.max_inflight and self._ring:
            tenant = self._ring[0]
            q = self._queues.get(tenant)
            # Skip abandoned waiters (timeout/disconnect).
            while q and (q[0].done() or q[0].cancelled()):
                q.popleft()
            if not q:
                self._ring.popleft()
                self._queues.pop(tenant, None)
                self._deficit.pop(tenant, None)
                continue
            self._deficit[tenant] = min(
                self._deficit.get(tenant, 0.0) + _QUANTUM, 4 * _QUANTUM)
            served = False
            while q and self._deficit[tenant] >= _COST and \
                    self.inflight < self.max_inflight:
                fut = q.popleft()
                if fut.done() or fut.cancelled():
                    continue
                self._deficit[tenant] -= _COST
                self.inflight += 1
                self._waiting -= 1
                fut.set_result(None)
                served = True
            # Rotate: next tenant gets the next quantum.
            self._ring.rotate(-1)
            if not q:
                # Clean exit for the emptied queue on its next visit.
                self._deficit[tenant] = 0.0
            if not served and len(self._ring) == 1 and not q:
                break
        self._publish_inflight()
