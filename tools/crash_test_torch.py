"""Kill-9 crash-recovery drill for the port's durable index (the
counterpart of ``tools/crash_test.py``, on ``repro_torch``).

A CHILD process runs a seeded scripted mutation workload against a durable
directory, printing an ack line after every mutation the WAL has fsync'd;
the PARENT SIGKILLs it at a chosen ack (no atexit, no flushing), reopens
the directory with ``persist.open_engine`` and asserts that the recovered
engine's search results equal, bit for bit, those of an engine that
replays exactly the acknowledged prefix of the same workload.

The parent builds the starting index once and writes it as ``interop``
arrays next to the directory under test; the child and the parent's
reference engine both start from that file, because an index built on the
card is not bit-reproducible across processes. The mutation stream is
derived from ``--seed`` alone.

Usage:
    python tools/crash_test_torch.py [--kill-at 5] [--steps 12] [--seed 7] \
        [--dir DIR] [--sweep] [--replication] [--device cuda]

``--kill-at N`` kills after the N-th ack (default: seeded random step);
``--sweep`` runs every kill point 1..steps. ``--replication`` runs the
failover drill instead: the child is a PRIMARY that ships each mutation's
WAL segment through a ``DirTransport`` before acking; the parent SIGKILLs
it, replays the shipped chain into a warm STANDBY, promotes it, and
asserts (a) the promoted replica equals an engine that replays exactly the
shipped prefix, (b) the deposed primary's next append and ship both raise
``FencedError``, and (c) standby reads serve before, during and after the
transition. ``--device`` defaults to the CUDA card. Exits non-zero on any
mismatch. Imports neither jax nor the JAX package.
"""
from __future__ import annotations

import argparse
import os
import pathlib
import shutil
import signal
import subprocess
import sys
import tempfile
import time

_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(_ROOT / "src") not in sys.path:
    sys.path.insert(0, str(_ROOT / "src"))

NLIST = 16
D = 32
M = 8
ACK = "ACK"


def seed_index(path: str, device: str) -> None:
    """Build the drill's starting engine once and write it as interop
    arrays to ``path`` (.npz)."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.data import vectors
    from repro_torch.engine import SearchEngine

    ds = vectors.make_sift_like(n=2000, nt=1000, nq=6, d=D, ncl=16, seed=5,
                                device=device)
    eng = SearchEngine.build(ds.train, ds.base, m=M, nlist=NLIST,
                             coarse_iters=4, pq_iters=4, device=device)
    arrays = interop.arrays_from_engine(eng)
    arrays["queries"] = ds.queries.cpu().numpy()
    np.savez(path, **arrays)


def load_engine(path: str, device: str):
    """(queries, engine) from the drill's seed file."""
    import numpy as np

    from repro_torch import interop
    from repro_torch.engine import EngineConfig

    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    queries = arrays.pop("queries")
    eng = interop.engine_from_arrays(
        arrays, config=EngineConfig(nprobe=6, rerank_mult=2), device=device)
    return queries, eng


def scripted_ops(steps: int, seed: int):
    """Deterministic mutation stream; every op logs exactly one WAL record
    (delete slabs are disjoint, so each finds live rows)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ops = []
    for i in range(steps):
        r = i % 4
        if r == 3:
            ops.append(("compact",))
        elif r == 1:
            ops.append(("delete", np.arange(60 * i, 60 * i + 40)))
        else:
            ids = np.arange(2000 + 50 * i, 2000 + 50 * i + 30)
            ops.append(("upsert", ids,
                        rng.normal(size=(30, D)).astype(np.float32)))
    return ops


def apply_op(eng, op):
    if op[0] == "upsert":
        eng.upsert(op[1], op[2])
    elif op[0] == "delete":
        eng.delete(op[1])
    else:
        eng.compact()


def same_results(a, b, q) -> bool:
    import torch

    ra, rb = a.search(q, 10), b.search(q, 10)
    return all(torch.equal(x, y) for x, y in zip(
        (ra.dists, ra.ids, *ra.stats), (rb.dists, rb.ids, *rb.stats)))


def child_main(args) -> int:
    """Run the workload, printing one ack per durably logged mutation."""
    from repro_torch import persist

    _q, eng = load_engine(args.seed_file, args.device)
    persist.ensure_attached(eng, args.dir)
    print(f"{ACK} 0", flush=True)
    for i, op in enumerate(scripted_ops(args.steps, args.seed), start=1):
        apply_op(eng, op)
        # the WAL record was fsync'd before the write: this op survives
        # any crash from here on, which is what the ack promises
        print(f"{ACK} {i}", flush=True)
    return 0


def child_repl_main(args) -> int:
    """Primary side: every mutation is shipped before it is acked."""
    from repro_torch import persist

    primary_dir = os.path.join(args.dir, "primary")
    _q, eng = load_engine(args.seed_file, args.device)
    persist.ensure_attached(eng, primary_dir)
    transport = persist.DirTransport(os.path.join(args.dir, "ship"))
    shipper = persist.WALShipper(eng, primary_dir, transport, term=0)
    shipper.ship_once()
    print(f"{ACK} 0", flush=True)
    for i, op in enumerate(scripted_ops(args.steps, args.seed), start=1):
        apply_op(eng, op)
        shipper.ship_once()
        print(f"{ACK} {i}", flush=True)
    return 0


def spawn_and_kill(args, kill_at: int, directory: str,
                   replication: bool) -> int:
    """Start the child, SIGKILL it after ack ``kill_at``; returns the last
    ack read (-1 if none)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child",
           "--dir", directory, "--steps", str(args.steps), "--seed",
           str(args.seed), "--device", args.device, "--seed-file",
           args.seed_file]
    if replication:
        cmd.append("--replication")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True,
                            cwd=str(_ROOT))
    acked = -1
    try:
        for line in proc.stdout:
            if not line.startswith(ACK):
                continue
            acked = int(line.split()[1])
            if acked >= kill_at:
                os.kill(proc.pid, signal.SIGKILL)
                break
    finally:
        proc.stdout.close()
        try:
            proc.wait(timeout=120)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return acked


def run_one(args, kill_at: int, directory: str) -> bool:
    from repro_torch import persist

    shutil.rmtree(directory, ignore_errors=True)
    acked = spawn_and_kill(args, kill_at, directory, replication=False)
    if acked < kill_at:
        print(f"FAIL kill_at={kill_at}: child finished after {acked} acks "
              "before the kill landed (raise --steps)")
        return False
    t0 = time.monotonic()
    rec, info = persist.open_engine(directory, attach=False,
                                    device=args.device)
    dt = time.monotonic() - t0
    # the kill may land after further unread acks: the WAL is the source
    # of truth, and recovery must cover at least every ack read
    if info.last_seq < acked:
        print(f"FAIL kill_at={kill_at}: child acked {acked} mutations but "
              f"recovery replayed only to seq {info.last_seq}")
        return False
    q, ref = load_engine(args.seed_file, args.device)
    for op in scripted_ops(args.steps, args.seed)[:info.last_seq]:
        apply_op(ref, op)
    if not same_results(rec, ref, q):
        print(f"FAIL kill_at={kill_at}: recovered state (seq "
              f"{info.last_seq}) differs from the replay of that prefix")
        return False
    print(f"ok kill_at={kill_at}: acked>={acked}, recovered seq "
          f"{info.last_seq} (snapshot {info.snapshot!r}, replayed "
          f"{info.replayed}, wal tail truncated {info.truncated_bytes}B) "
          f"in {dt:.2f}s, bit for bit")
    return True


def run_replication(args, kill_at: int, directory: str) -> bool:
    from repro_torch import persist
    from repro_torch.persist.errors import FencedError

    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    acked = spawn_and_kill(args, kill_at, directory, replication=True)
    if acked < kill_at:
        print(f"FAIL kill_at={kill_at}: primary finished after {acked} acks "
              "before the kill landed (raise --steps)")
        return False
    transport = persist.DirTransport(os.path.join(directory, "ship"))
    q, standby = load_engine(args.seed_file, args.device)
    replica = persist.StandbyReplica(standby, transport)

    def read_ok(when):
        try:
            standby.search(q, 10).ids.cpu()
            return True
        except Exception as exc:  # noqa: BLE001 - the drill reports
            print(f"FAIL kill_at={kill_at}: standby read errored {when}: "
                  f"{exc!r}")
            return False

    if not read_ok("before replay"):
        return False
    replica.poll_once()
    if not read_ok("after replay"):
        return False
    if replica.applied_seq < acked:
        print(f"FAIL kill_at={kill_at}: primary acked {acked} shipped ops "
              f"but the standby replayed only to seq {replica.applied_seq}")
        return False
    t0 = time.monotonic()
    new_term = replica.promote(os.path.join(directory, "standby"))
    dt = time.monotonic() - t0
    if not read_ok("after promote"):
        return False
    _q, ref = load_engine(args.seed_file, args.device)
    for op in scripted_ops(args.steps, args.seed)[:replica.applied_seq]:
        apply_op(ref, op)
    if not same_results(standby, ref, q):
        print(f"FAIL kill_at={kill_at}: the promoted standby (seq "
              f"{replica.applied_seq}) differs from the replay of that "
              "prefix")
        return False
    primary_dir = os.path.join(directory, "primary")
    old = persist.open_engine(primary_dir, device=args.device)[0]
    old._wal.guard = persist.make_fence_guard(transport, 0)
    old_shipper = persist.WALShipper(old, primary_dir, transport, term=0)
    for what, act in (("shipped", old_shipper.ship_once),
                      ("appended", lambda: old.delete(list(range(3))))):
        try:
            act()
        except FencedError:
            continue
        print(f"FAIL kill_at={kill_at}: the deposed primary {what} at term "
              f"0 after promotion to term {new_term}")
        return False
    print(f"ok kill_at={kill_at}: acked>={acked}, standby replayed seq "
          f"{replica.applied_seq}, promoted to term {new_term} in {dt:.2f}s,"
          " bit for bit, deposed primary fenced")
    return True


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--seed-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--dir", default=None,
                    help="durable directory (default: a fresh temp dir)")
    ap.add_argument("--steps", type=int, default=12,
                    help="mutations in the scripted workload")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--kill-at", type=int, default=None,
                    help="SIGKILL after this ack (default: seeded random)")
    ap.add_argument("--sweep", action="store_true",
                    help="run every kill point 1..steps")
    ap.add_argument("--replication", action="store_true",
                    help="run the ship/promote failover drill instead")
    ap.add_argument("--device", default="cuda",
                    help="torch device of every engine (default: cuda)")
    args = ap.parse_args()

    if args.child:
        return (child_repl_main(args) if args.replication
                else child_main(args))

    tmp = None
    directory = args.dir
    if directory is None:
        tmp = tempfile.mkdtemp(prefix="crash_test_torch_")
        directory = os.path.join(tmp, "d")
    try:
        args.seed_file = os.path.abspath(directory) + ".seed.npz"
        os.makedirs(os.path.dirname(args.seed_file), exist_ok=True)
        seed_index(args.seed_file, args.device)
        if args.sweep:
            points = list(range(1, args.steps + 1))
        else:
            import random
            points = [args.kill_at if args.kill_at is not None
                      else random.Random(args.seed).randint(1, args.steps)]
        run = run_replication if args.replication else run_one
        failures = sum(not run(args, p, directory) for p in points)
        if failures:
            print(f"{failures}/{len(points)} kill points FAILED")
            return 1
        print(f"all {len(points)} kill point(s) recovered bit for bit")
        return 0
    finally:
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
