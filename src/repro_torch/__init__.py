"""PyTorch + CUDA port of the ``repro`` ANN search engine (NVIDIA Hopper).

Mirrors ``src/repro/`` module for module. Plain tensor code is PyTorch; the
kernels of the serving engine -- the 4-bit stream scan with fused per-tile
top-kc and its early-exit variant, the in-place and the two gathered
grouped scans, and the gather-free exact re-rank (``kernels/*_kernel.py``)
-- are hand-written CUDA C++ for ``sm_90a`` under ``kernels/csrc/``, built
with ``nvcc`` at first use.

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

from repro_torch.engine import (EngineConfig, QueryStats,  # noqa: E402
                                SearchEngine, SearchResult)

__all__ = ["EngineConfig", "QueryStats", "SearchEngine", "SearchResult"]
