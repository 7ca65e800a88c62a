"""Checkpointing in the reference's on-disk format: atomic commit, keep-k,
asynchronous writes (the port of ``repro/train/checkpoint.py``).

A state is flattened to named host arrays, written as
``<dir>/step_%08d/shard_00000.npz`` plus a JSON ``manifest.json`` (names,
shapes, dtypes, ``host_count`` 1, ``format_version`` 1), and committed by
an atomic directory rename. The names are the reference's, as its
``_flatten_with_names`` writes them for a ``TrainState``:
``.params/embedding``, ``.params/stack/blocks/attn/wq`` (a parameter of
every layer stacked on a leading layer axis), ``.opt/.step``,
``.opt/.mu/...``, ``.opt/.nu/...`` and, when present,
``.ef_error/...``. A NamedTuple's field is ``.<field>``; a dict's keys are
taken as the reference's path keys (a parameter's dotted name through
``layers.tree_key``), in the order the reference's tree flattening
gives them (dict keys sorted, fields in order).

bf16 is written as the reference writes it: numpy has no bfloat16, and
the reference's arrays (``ml_dtypes``) go into the npz as raw 2-byte
void, ``'<V2'`` in the array header, with ``"bfloat16"`` in the manifest.
The port writes the same bytes from the bits, and reads such an array by
viewing its bits as int16 and then as ``torch.bfloat16``, guided by the
manifest. So it opens the reference's bf16 checkpoints, which the
reference itself cannot restore (ROADMAP Queue 3), and its own, without
``ml_dtypes``. A bf16 array is never written as uint16: the reference
would value-cast those integers to wrong numbers without a word.

``restore`` copies into the tensors of ``like`` in place (the
counterpart of the reference's new pytree: a module is not rebuilt) and
returns it.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any

import numpy as np
import torch
from torch import nn

from repro_torch.models import layers as ll

MANIFEST = "manifest.json"
BF16 = "bfloat16"
READERS = 8              # threads reading a checkpoint's arrays


def _leaves(tree: Any, path: tuple = ()):
    """(path parts, layer index or None, tensor) of every tensor in
    ``tree``, in the reference's flattening order."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield path, None, tree
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _leaves(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (nn.Module, dict)):
        items = (tree.named_parameters() if isinstance(tree, nn.Module)
                 else tree.items())
        found = []
        for name, v in items:
            if isinstance(v, torch.Tensor):
                key, layer = ll.tree_key(name)
                found.append((tuple(key.split("/")), layer, v))
            else:
                found += [(((name,) + p), layer, t)
                          for p, layer, t in _leaves(v)]
        found.sort(key=lambda x: (x[0], -1 if x[1] is None else x[1]))
        yield from ((path + p, layer, t) for p, layer, t in found)
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__}")


def _named(tree: Any) -> dict[str, list]:
    """name -> [(layer index or None, tensor), ...] in flattening order."""
    out: dict[str, list] = {}
    for path, layer, t in _leaves(tree):
        out.setdefault("/".join(path), []).append((layer, t))
    return out


def _host(t: torch.Tensor) -> np.ndarray:
    """A copy on the host (never a view of a CPU tensor that training goes
    on updating in place)."""
    t = t.detach()
    bf16 = t.dtype == torch.bfloat16
    a = (t.view(torch.int16) if bf16 else t).to("cpu", copy=True).numpy()
    return a.view("V2") if bf16 else a


def _flatten_with_names(state: Any) -> dict[str, np.ndarray]:
    """The state as named host arrays (a layer axis stacked where a name
    has one tensor a layer), bf16 as 2-byte void."""
    out = {}
    for name, parts in _named(state).items():
        if parts[0][0] is None:
            out[name] = _host(parts[0][1])
        else:
            out[name] = _host(torch.stack([t for _, t in parts]))
    return out


def _dtype_name(a: np.ndarray) -> str:
    return BF16 if a.dtype == np.dtype("V2") else str(a.dtype)


def _savez(path: str, arrays: dict[str, np.ndarray]) -> None:
    """What ``np.savez`` writes (uncompressed zip64 members, each a
    version 1.0 .npy), a bf16 array's header saying ``'<V2'`` as numpy
    writes it for an ``ml_dtypes`` bfloat16. Each array's data goes out
    in one write, which computes its CRC and writes without the
    interpreter lock (a training loop runs beside the writer)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, val in arrays.items():
            val = np.require(val, requirements="C")   # keeps a 0-d shape
            header = np.lib.format.header_data_from_array_1_0(val)
            if val.dtype == np.dtype("V2"):
                header["descr"] = "<V2"
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                np.lib.format.write_array_header_1_0(f, header)
                f.write(memoryview(val.reshape(-1).view(np.uint8)))


def _commit(ckpt_dir: str, step: int, arrays: dict[str, np.ndarray],
            host_id: int, keep: int) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = tempfile.mkdtemp(prefix=f".tmp_step_{step}_", dir=ckpt_dir)
    _savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), arrays)
    manifest = {
        "step": step,
        "names": sorted(arrays.keys()),
        "shapes": {k: list(v.shape) for k, v in arrays.items()},
        "dtypes": {k: _dtype_name(v) for k, v in arrays.items()},
        "host_count": 1,
        "format_version": 1,
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):  # idempotent re-save at the same step
        shutil.rmtree(final)
    os.rename(tmp, final)      # atomic commit
    _gc(ckpt_dir, keep)
    return final


def save(ckpt_dir: str, step: int, state: Any, *, host_id: int = 0,
         keep: int = 3) -> str:
    """Write state atomically as <ckpt_dir>/step_<n>/. Returns the path."""
    return _commit(ckpt_dir, step, _flatten_with_names(state), host_id, keep)


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_"))
    for d in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    # clean stale tmp dirs from crashed writers
    for d in os.listdir(ckpt_dir):
        if d.startswith(".tmp_"):
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and os.path.exists(
                 os.path.join(ckpt_dir, d, MANIFEST))]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    """A host array as a tensor; 2-byte void is bf16 bits when the
    manifest says bfloat16."""
    if arr.dtype == np.dtype("V2"):
        if dtype_name != BF16:
            raise ValueError(f"2-byte void array recorded as {dtype_name!r}")
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _npy_header(f) -> tuple[tuple, np.dtype]:
    version = np.lib.format.read_magic(f)
    read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
            else np.lib.format.read_array_header_2_0)
    shape, fortran, dtype = read(f)
    if fortran:
        raise ValueError("a Fortran-ordered array in a checkpoint")
    return shape, dtype


def _shapes(path: str) -> dict[str, tuple]:
    """name -> shape of every array of an npz, from the headers alone."""
    with zipfile.ZipFile(path) as zf:
        out = {}
        for name in zf.namelist():
            if name.endswith(".npy"):
                with zf.open(name) as f:
                    out[name[:-4]] = _npy_header(f)[0]
        return out


def _read(path: str, name: str) -> np.ndarray:
    """One array of an npz, read whole; the zip's CRC is checked at the
    end of the member, as ``np.load`` checks it."""
    with zipfile.ZipFile(path) as zf, zf.open(name + ".npy") as f:
        shape, dtype = _npy_header(f)
        arr = np.empty(shape, dtype)
        buf = memoryview(arr.reshape(-1).view(np.uint8))
        if f.readinto(buf) != buf.nbytes or f.read(1):
            raise ValueError(f"{name}: array data of the wrong length")
    return arr


@torch.no_grad()
def restore(ckpt_dir: str, like: Any, step: int | None = None
            ) -> tuple[int, Any]:
    """Restore into the tensors of ``like`` in place, each cast to its
    tensor's dtype on its device. Returns (step, like).

    Every name and shape is checked against the headers before any
    tensor is written (the reference's errors: an incomplete checkpoint,
    an array missing, a shape mismatch), so a failed restore leaves
    ``like`` as it was. The arrays are read by READERS threads (the zip
    CRC and the file reads release the interpreter lock) and copied in
    the main thread."""
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    where = {}                 # name -> (its shard, its shape)
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".npz"):
            path = os.path.join(d, fn)
            where.update({k: (path, shape)
                          for k, shape in _shapes(path).items()})
    missing = set(manifest["names"]) - set(where)
    if missing:
        raise ValueError(
            f"checkpoint incomplete, missing arrays: {sorted(missing)[:5]}")
    named = _named(like)
    for name, parts in named.items():
        if name not in where:
            raise KeyError(f"array {name!r} not in checkpoint")
        stacked = parts[0][0] is not None
        want_shape = ((len(parts),) if stacked else ()) \
            + tuple(parts[0][1].shape)
        if tuple(where[name][1]) != want_shape:
            raise ValueError(f"{name}: checkpoint shape {where[name][1]} "
                             f"!= {want_shape}")
    with ThreadPoolExecutor(max_workers=READERS) as pool:
        arrays = pool.map(lambda n: _read(where[n][0], n), named)
        for (name, parts), arr in zip(named.items(), arrays):
            src = _tensor(arr, manifest["dtypes"].get(name, str(arr.dtype)))
            stacked = parts[0][0] is not None
            for i, (_, t) in enumerate(parts):
                t.copy_(src[i] if stacked else src)
    return step, like


class AsyncCheckpointer:
    """Overlaps checkpoint writes with training (one write in flight).

    ``save`` copies the state to host arrays before its thread starts, so
    training may go on updating the state in place at once."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, state: Any) -> None:
        self.wait()
        host_state = _flatten_with_names(state)  # snapshot before async

        def run():
            try:
                _commit(self.ckpt_dir, step, host_state, 0, self.keep)
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
