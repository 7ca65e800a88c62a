"""Carry an index across as plain numpy arrays.

The dict has the keys the reference's snapshot writes for a single-host
engine: ``codes``, ``ids``, ``sizes``, optional ``attrs`` (the list store),
``centroids``, ``codebook`` (the (M, 16, dsub) codewords) and optional
``base`` / ``base_norms``. An index built by ``repro`` reaches the port
through this dict, and ``arrays_from_engine`` writes the same dict back.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ivf import IVFIndex
from repro_torch.core.lists import store_arrays, store_from_arrays
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device
from repro_torch.engine.engine import EngineConfig, SearchEngine

# keys a snapshot may carry for features the port does not have yet
_NOT_PORTED = {"live_bits": "tombstones (mutation)",
               "ns_member": "namespaces"}


def _f32(arrays: dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key], np.float32)).to(dev)


def index_from_arrays(arrays: dict[str, np.ndarray],
                      device: str | torch.device | None = None) -> IVFIndex:
    """Rebuild an ``IVFIndex`` on ``device`` (None = the CUDA card)."""
    dev = resolve_device(device)
    return IVFIndex(centroids=_f32(arrays, "centroids", dev),
                    codebook=PQCodebook(_f32(arrays, "codebook", dev)),
                    lists=store_from_arrays(arrays, device=dev))


def engine_from_arrays(arrays: dict[str, np.ndarray], *,
                       config: EngineConfig | None = None,
                       device: str | torch.device | None = None
                       ) -> SearchEngine:
    """Rebuild a flat-coarse ``SearchEngine`` on ``device``, with the base
    and its norms when the dict carries them."""
    for key, what in _NOT_PORTED.items():
        if key in arrays:
            raise NotImplementedError(
                f"arrays carry {key!r}: {what} is not yet ported to "
                "repro_torch")
    dev = resolve_device(device)
    index = index_from_arrays(arrays, dev)
    base = _f32(arrays, "base", dev) if "base" in arrays else None
    norms = (_f32(arrays, "base_norms", dev)
             if base is not None and "base_norms" in arrays else None)
    return SearchEngine(index, base=base, config=config, base_norms=norms)


def arrays_from_engine(engine: SearchEngine) -> dict[str, np.ndarray]:
    """The inverse: an engine's index (and base) as host arrays."""
    idx = engine.index
    out = dict(store_arrays(idx.lists))
    out["centroids"] = idx.centroids.cpu().numpy()
    out["codebook"] = idx.codebook.codewords.cpu().numpy()
    if engine.base is not None:
        out["base"] = engine.base.cpu().numpy()
        out["base_norms"] = engine.base_norms.cpu().numpy()
    return out
