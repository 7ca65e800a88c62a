"""PyTorch + CUDA port of the ``repro`` ANN search engine (NVIDIA Hopper).

Mirrors ``src/repro/`` module for module. Plain tensor code is PyTorch; the
kernels -- the 4-bit stream scan with fused per-tile top-kc and its
early-exit variant, the in-place and the two gathered grouped scans, the
gather-free exact re-rank, and the flat index's two scans and fused block
minimum (``kernels/*_kernel.py``) -- are hand-written CUDA C++ for
``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` at first use.

Two entry points: the IVF serving engine (``SearchEngine``, flat, HNSW or
k-means-tree coarse; ``ShardedEngine`` partitions it across shards) and the flat
fast-scan index with the naive-PQ baseline beside it, the paper's Fig. 2
pair (``core.fastscan.build_index`` / ``search`` returning a
``FastScanIndex`` and its results; ``core.pq.search``).

The package imports neither ``jax`` nor ``repro``; it keeps its own copy of
everything it needs.

Numerics: float32 matrix products must stay in full f32 (the coarse
``pairwise_sqdist``, the LUT build and the exact re-rank are all held to the
JAX reference within a stated f32 tolerance), so importing this package
turns TF32 off for both cuBLAS and cuDNN.

Entry points run on the CUDA card unless the caller passes ``device='cpu'``;
they never fall back to the CPU on their own.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from repro_torch.core.fastscan import FastScanIndex  # noqa: E402
from repro_torch.engine import (EngineConfig, QueryStats,  # noqa: E402
                                SearchEngine, SearchResult, ShardedEngine)

__all__ = ["EngineConfig", "FastScanIndex", "QueryStats", "SearchEngine",
           "SearchResult", "ShardedEngine"]
