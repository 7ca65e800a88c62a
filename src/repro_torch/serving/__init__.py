"""Async batched ANN serving on top of ``repro_torch.engine`` (counterpart
of ``repro.serving``; the reference's docs/serving.md).

A dynamic micro-batching layer that turns ragged request streams into the
static shape buckets the engine's CUDA graphs (``search_jit``) want:

  - ``Batcher``       thread-safe queue; groups by ``k``, pads to buckets
  - ``ServingLoop``   dispatch thread; futures + asyncio entry points
  - ``ServeResult``   per-request results + work counters + latency
  - ``StatsRegistry`` / ``TenantStats``  per-caller accounting

Quickstart::

    from repro_torch.serving import ServingLoop
    loop = ServingLoop(engine, rerank_mult=4).start(warmup=True)
    fut = loop.submit(query, k=10, tenant="alice")
    print(fut.result().ids)
    loop.stop()
"""
from repro_torch.serving.batcher import (  # noqa: F401
    DEFAULT_BUCKETS,
    Batcher,
    Request,
    bucket_for,
    pad_to_bucket,
)
from repro_torch.serving.errors import (  # noqa: F401
    DeadlineExceeded,
    LoopClosed,
    NotPrimary,
    Overloaded,
)
from repro_torch.serving.loop import LoopMetrics, ServeResult, ServingLoop  # noqa: F401
from repro_torch.serving.stats import StatsRegistry, TenantStats  # noqa: F401
