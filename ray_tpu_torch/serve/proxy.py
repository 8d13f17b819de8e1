"""Back-compat name (as in ``ray_tpu/serve/proxy.py``): the HTTP ingress
lives in ``ray_tpu_torch.serve.ingress`` (async HTTP/SSE data path, admission
control, per-tenant fairness). Import ``HTTPProxy`` from there."""

from ray_tpu_torch.serve.ingress.server import HTTPProxy  # noqa: F401

__all__ = ["HTTPProxy"]
