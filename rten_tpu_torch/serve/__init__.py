"""Serving: continuous batching over slot KV caches (``ServingEngine``) or a
shared page pool (``PagedServingEngine``), an HTTP/JSON API over either
(``ServingServer``), and session checkpoint and resume (``checkpoint``)."""

from rten_tpu_torch.serve.checkpoint import (
    load_snapshot,
    restore_backend,
    restore_engine,
    save_snapshot,
    snapshot_backend,
    snapshot_engine,
)
from rten_tpu_torch.serve.engine import Request, ServingEngine
from rten_tpu_torch.serve.http import ServingServer
from rten_tpu_torch.serve.paged import PagedServingEngine, PagePool

__all__ = ["Request", "ServingEngine", "PagedServingEngine", "PagePool", "ServingServer", "snapshot_engine",
           "restore_engine", "snapshot_backend", "restore_backend", "save_snapshot", "load_snapshot"]
