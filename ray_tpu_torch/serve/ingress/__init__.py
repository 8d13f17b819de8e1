"""HTTP/SSE ingress tier of the port (the counterpart of
``ray_tpu/serve/ingress``; reference: ``serve/_private/http_proxy.py`` +
the proxy-side request router), on the standard library's ``asyncio``:

- ``server.HTTPProxy``      — async HTTP ingress actor: non-streaming
                              calls run on a DEDICATED bounded thread
                              pool (never the asyncio default
                              executor), and ``/v1/completions``
                              streams tokens end-to-end over
                              Server-Sent Events, with client
                              disconnects cancelling the engine request
                              and freeing its slot/KV blocks.
- ``admission.AdmissionController`` — per-proxy concurrency budget,
                              queue-depth watermarks that SHED with
                              ``429 + Retry-After`` (typed
                              ``ServeOverloadedError``) before replicas
                              saturate, per-tenant token buckets and
                              deficit-round-robin queue service keyed
                              on the tenant header.

Ingress metrics (``serve_ingress_inflight``,
``serve_ingress_shed_total``, per-tenant latency histograms) flow
through ``ray_tpu_torch.util.metrics`` to the dashboard's ``/metrics``.
"""

from ray_tpu_torch.serve.ingress.admission import (  # noqa: F401
    AdmissionController,
    TokenBucket,
)
from ray_tpu_torch.serve.ingress.server import HTTPProxy  # noqa: F401

__all__ = ["HTTPProxy", "AdmissionController", "TokenBucket"]
