"""Serving: continuous batching over slot KV caches (``ServingEngine``) or a
shared page pool (``PagedServingEngine``), and an HTTP/JSON API over either
(``ServingServer``)."""

from rten_tpu_torch.serve.engine import Request, ServingEngine
from rten_tpu_torch.serve.http import ServingServer
from rten_tpu_torch.serve.paged import PagedServingEngine, PagePool

__all__ = ["Request", "ServingEngine", "PagedServingEngine", "PagePool", "ServingServer"]
