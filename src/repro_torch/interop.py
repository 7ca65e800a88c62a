"""Carry an index across as plain numpy arrays.

The dict has the keys the reference's snapshot writes for a single-host
engine: ``codes``, ``ids``, ``sizes``, optional ``attrs`` (the list store),
``centroids``, ``codebook`` (the (M, 16, dsub) codewords) and optional
``base`` / ``base_norms``, ``ns_member`` (the (n_ns, nlist) bool
namespace table) and, while the store holds tombstones, ``live_bits`` (the
packed live-row bitmap). An index built or mutated by ``repro`` reaches
the port through this dict, and ``arrays_from_engine`` writes the same dict
back.

A coarse quantizer crosses as arrays too (``coarse_from_arrays`` /
``arrays_from_coarse``, and inside the engine's dict): an HNSW graph as
``hnsw_vectors``, ``hnsw_level0``, ``hnsw_entry`` and, for each upper level
l = 1, 2, ..., ``hnsw_ids_<l>`` and ``hnsw_adj_<l>``; a k-means tree as
``tree_roots``, ``tree_children`` and ``tree_centroids``. Without these keys
an engine gets the flat quantizer.

A flat fast-scan index (``core.fastscan.FastScanIndex``) crosses as
``codewords`` ((M, 16, dsub) f32), ``packed_codes`` ((N, M//2) u8) and
``n``: ``fastscan_index_from_arrays`` / ``arrays_from_fastscan_index``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import coarse as coarse_mod
from repro_torch.core.fastscan import FastScanIndex
from repro_torch.core.hnsw import HNSWGraph
from repro_torch.core.ivf import IVFIndex
from repro_torch.core.lists import store_arrays, store_from_arrays
from repro_torch.core.pq import PQCodebook
from repro_torch.device import resolve_device
from repro_torch.engine.engine import EngineConfig, SearchEngine


def _f32(arrays: dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key], np.float32)).to(dev)


def _i32(arrays: dict, key: str, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(arrays[key], np.int32)).to(dev)


def coarse_from_arrays(arrays: dict[str, np.ndarray],
                       device: str | torch.device | None = None):
    """The HNSW or tree quantizer the dict carries, on ``device`` (None =
    the CUDA card), or None when it carries neither."""
    dev = resolve_device(device)
    if "hnsw_level0" in arrays:
        uppers, lvl = [], 1
        while f"hnsw_ids_{lvl}" in arrays:
            uppers.append((_i32(arrays, f"hnsw_ids_{lvl}", dev),
                           _i32(arrays, f"hnsw_adj_{lvl}", dev)))
            lvl += 1
        return coarse_mod.HNSWCoarse(HNSWGraph(
            vectors=_f32(arrays, "hnsw_vectors", dev),
            level0=_i32(arrays, "hnsw_level0", dev), uppers=tuple(uppers),
            entry=int(arrays["hnsw_entry"])))
    if "tree_roots" in arrays:
        return coarse_mod.TreeCoarse(
            roots=_f32(arrays, "tree_roots", dev),
            children=_i32(arrays, "tree_children", dev),
            centroids=_f32(arrays, "tree_centroids", dev))
    return None


def arrays_from_coarse(coarse) -> dict[str, np.ndarray]:
    """The inverse: an HNSW or tree quantizer as host arrays; a flat one
    gives an empty dict (the index's centroids are the whole of it)."""
    if isinstance(coarse, coarse_mod.HNSWCoarse):
        g = coarse.graph
        out = {"hnsw_vectors": g.vectors.cpu().numpy(),
               "hnsw_level0": g.level0.cpu().numpy(),
               "hnsw_entry": np.asarray(g.entry, np.int64)}
        for lvl, (ids, adj) in enumerate(g.uppers, start=1):
            out[f"hnsw_ids_{lvl}"] = ids.cpu().numpy()
            out[f"hnsw_adj_{lvl}"] = adj.cpu().numpy()
        return out
    if isinstance(coarse, coarse_mod.TreeCoarse):
        return {"tree_roots": coarse.roots.cpu().numpy(),
                "tree_children": coarse.children.cpu().numpy(),
                "tree_centroids": coarse.centroids.cpu().numpy()}
    return {}


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
    """Rebuild a ``SearchEngine`` on ``device``, with the base and its
    norms, the namespace table, the live-row bitmap and the HNSW or tree
    quantizer when the dict carries them (else flat coarse; the engine
    derives the bitmap from the ids; a carried one is installed as it is,
    as the reference's snapshot loader does)."""
    dev = resolve_device(device)
    index = index_from_arrays(arrays, dev)
    base = _f32(arrays, "base", dev) if "base" in arrays else None
    norms = (_f32(arrays, "base_norms", dev)
             if base is not None and "base_norms" in arrays else None)
    member = (torch.from_numpy(np.array(arrays["ns_member"], bool))
              if "ns_member" in arrays else None)
    live = (torch.from_numpy(np.array(arrays["live_bits"], np.uint8))
            if "live_bits" in arrays else None)
    coarse = coarse_from_arrays(arrays, dev)
    return SearchEngine(index, base=base, config=config, base_norms=norms,
                        namespaces=member, live_bits=live,
                        coarse="flat" if coarse is None else coarse)


def arrays_from_engine(engine: SearchEngine) -> dict[str, np.ndarray]:
    """The inverse: an engine's index (and base, live-row bitmap, namespace
    table, HNSW or tree quantizer) as host arrays."""
    idx = engine.index
    out = dict(store_arrays(idx.lists))
    out["centroids"] = idx.centroids.cpu().numpy()
    out["codebook"] = idx.codebook.codewords.cpu().numpy()
    if engine.base is not None:
        out["base"] = engine.base.cpu().numpy()
        out["base_norms"] = engine.base_norms.cpu().numpy()
    if engine.live_bits is not None:
        out["live_bits"] = engine.live_bits.cpu().numpy()
    if engine.ns_member is not None:
        out["ns_member"] = engine.ns_member.cpu().numpy()
    out.update(arrays_from_coarse(engine.coarse))
    return out


def fastscan_index_from_arrays(arrays: dict[str, np.ndarray],
                               device: str | torch.device | None = None
                               ) -> FastScanIndex:
    """Rebuild a flat ``FastScanIndex`` on ``device`` (None = the CUDA
    card) from ``codewords``, ``packed_codes`` and ``n``."""
    dev = resolve_device(device)
    codes = torch.from_numpy(np.array(arrays["packed_codes"], np.uint8)
                             ).to(dev)
    return FastScanIndex(PQCodebook(_f32(arrays, "codewords", dev)), codes,
                         int(arrays["n"]))


def arrays_from_fastscan_index(index: FastScanIndex) -> dict[str, np.ndarray]:
    """The inverse: a flat index as host arrays."""
    return {"codewords": index.codebook.codewords.cpu().numpy(),
            "packed_codes": index.packed_codes.cpu().numpy(),
            "n": np.asarray(index.n, np.int64)}
