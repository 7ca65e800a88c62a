"""Build and bind the port's CUDA kernels.

``nvcc`` compiles each source under ``csrc/`` for ``sm_90a`` (all sources
at once, one process each) and links them into one shared library with a
plain C interface, which ``ctypes`` loads. Pointers and the stream pass as
``c_void_p``. The build runs at first use, never at import, into
``build/repro_torch_kernels/`` at the repo root (``REPRO_TORCH_BUILD_DIR``
overrides it), keyed by a hash of the sources and flags, so a later call in
the same checkout reuses it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("fastscan_stream_topk.cu", "rerank_stream_topk.cu",
           "fastscan_stream_grouped.cu", "fastscan_stream_topk_prune.cu",
           "fastscan_select_grouped.cu", "fastscan_onehot_mma_grouped.cu",
           "fastscan_select_flat.cu", "fastscan_onehot_mma_flat.cu",
           "fastscan_blockmin.cu", "pq_decode_attention.cu")
# included by the sources: part of the build key
HEADERS = ("fastscan_common.cuh", "fastscan_mma_flat.cuh")
# dynamic shared memory one block can get on Hopper
SMEM_LIMIT = 232448
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")
# per-kernel registers, shared memory and spills, kept in the build log
PTXAS_FLAGS = ("-Xptxas", "-v")
_REPO = Path(__file__).resolve().parents[3]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_log = ""          # nvcc output of the build this process ran or found
build_seconds = 0.0     # wall time of that build (0 when it was cached)

_VP, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "repro_fastscan_stream_topk": [_VP] * 5 + [_I] * 6 + [_VP] * 3,
    "repro_rerank_stream_topk": [_VP] * 4 + [_I] * 6 + [_VP] * 3,
    "repro_fastscan_stream_grouped": [_VP] * 3 + [_I] * 4 + [_VP] * 2,
    "repro_fastscan_stream_topk_prune": [_VP] * 8 + [_I] * 7 + [_VP] * 4,
    "repro_fastscan_select_grouped": [_VP] * 2 + [_I] * 4 + [_VP] * 2,
    "repro_fastscan_onehot_mma_grouped": [_VP] * 2 + [_I] * 4 + [_VP] * 2,
    "repro_fastscan_select_flat": [_VP] * 2 + [_I] * 3 + [_VP] * 2,
    "repro_fastscan_onehot_mma_flat": [_VP] * 2 + [_I] * 3 + [_VP] * 2,
    "repro_fastscan_blockmin": [_VP] * 2 + [_I] * 4 + [_VP] * 3,
    "repro_pq_decode_attention": [_VP] * 7 + [_I] * 9 + [_VP] * 4,
    "repro_pq_decode_split": [_VP] * 7 + [_I] * 9 + [_VP] * 2,
    "repro_pq_decode_combine": [_VP] + [_I] * 6 + [_VP] * 2,
    "repro_pq_decode_scores": [_VP] * 3 + [_I] * 5 + [_VP] * 2,
    "repro_pq_decode_values": [_VP] * 6 + [_I] * 7 + [_VP] * 2,
}
# each kernel's shared memory a CTA needs, as its source computes it (the
# one place the CTA shape lives), by its int arguments: M for K3, K5, K6
# and K7a-K7c, (tile_n, kc, M) for K1 and K4, (D, tile_r, k) for K2,
# (g, M, head_dim, quantize_q8) for K8's split pass (and its value pass),
# (g, M) for its scoring pass and Smax (or the count of gathered splits)
# for its combine pass
SMEM_FNS = {"repro_fastscan_stream_topk_smem": 3,
            "repro_rerank_stream_topk_smem": 3,
            "repro_fastscan_stream_grouped_smem": 1,
            "repro_fastscan_select_grouped_smem": 1,
            "repro_fastscan_onehot_mma_grouped_smem": 1,
            "repro_fastscan_select_flat_smem": 1,
            "repro_fastscan_onehot_mma_flat_smem": 1,
            "repro_fastscan_blockmin_smem": 1,
            "repro_fastscan_stream_topk_prune_smem": 3,
            "repro_pq_decode_attention_smem": 4,
            "repro_pq_decode_combine_smem": 1,
            "repro_pq_decode_combine_splits_smem": 1,
            "repro_pq_decode_scores_smem": 2}


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               _REPO / "build" / "repro_torch_kernels"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and Path("/usr/local/cuda/bin/nvcc").exists():
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "kernels/csrc at first use on a machine with the "
                           "CUDA toolkit")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + PTXAS_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    global build_log, build_seconds
    t0 = time.perf_counter()
    nvcc = _nvcc()
    tmp = Path(tempfile.mkdtemp(dir=out.parent))
    try:
        objs, procs = [], []
        for name in SOURCES:
            obj = tmp / (name + ".o")
            objs.append(str(obj))
            procs.append((name, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, *PTXAS_FLAGS, "-c", str(CSRC / name),
                 "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== nvcc {name}\n{text}")
            if proc.returncode:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o",
                               str(tmp / "lib.so"), *objs],
                              capture_output=True, text=True)
        logs.append(f"== nvcc -shared\n{link.stdout}{link.stderr}")
        if link.returncode:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
        build_log = "\n".join(logs)
        out.with_suffix(".log").write_text(build_log)
        os.replace(tmp / "lib.so", out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    build_seconds = time.perf_counter() - t0


def load_library() -> ctypes.CDLL:
    """Build (first call in a checkout) and load the kernels' library."""
    global _lib, build_log
    with _lock:
        if _lib is None:
            out = build_dir() / f"librepro_torch_kernels-{_digest()}.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                _compile(out)
            elif not build_log and out.with_suffix(".log").exists():
                build_log = out.with_suffix(".log").read_text()
            lib = ctypes.CDLL(str(out))
            for fn, argtypes in _SIGNATURES.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            for fn, nargs in SMEM_FNS.items():
                getattr(lib, fn).argtypes = [_I] * nargs
                getattr(lib, fn).restype = ctypes.c_longlong
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check_args(args: dict, device: torch.device) -> None:
    """Raise ``ValueError`` unless every ``name: (tensor, dtype, ndim)`` of
    ``args`` has that dtype and rank, is contiguous and lies on
    ``device`` -- what a kernel's plain C interface takes."""
    for name, (t, dtype, ndim) in args.items():
        if t.dtype != dtype or t.ndim != ndim:
            raise ValueError(f"{name}: want {ndim}-D {dtype}, got "
                             f"{t.ndim}-D {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, want {device}")


def check_smem(fn: str, *args: int, what: str = "") -> None:
    """Raise ``ValueError`` when a CTA of the kernel whose source exports
    ``fn`` needs more shared memory at ``args`` (M, K1's and K4's (tile_n,
    kc, M), K2's (D, tile_r, k), K8's (g, M, head_dim, quantize_q8) or its
    combine pass's Smax or splits) than a block can get."""
    need = getattr(load_library(), fn)(*args)
    if need > SMEM_LIMIT:
        raise ValueError(f"{what or f'M={args[0]}'} needs {need} B of shared "
                         f"memory, more than the {SMEM_LIMIT} B a block can "
                         "get")


def check(err: int, what: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err:
        msg = load_library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
