"""Subprocess body for the ``torch.distributed`` tests of
``test_torch_sharded.py`` and ``test_torch_sharding.py``: one rank of a
gloo group on the CPU.

    python tests/_torch_dist_harness.py <rank> <world size> <port>
    python tests/_torch_dist_harness.py <rank> 4 <port> constrain

Every rank builds the same engine from a seed, wraps it in a
``ShardedEngine`` of ``world size`` shards and checks that the
process-group path (this rank runs its own shard; results all-gathered,
stats all-reduced) equals the in-turn path bit for bit (dists, ids, all
seven ``QueryStats``), unfiltered, filtered and namespaced, then again
after a delete, an upsert and a compaction.

With ``constrain``, the four ranks form a (2, 2) ``("data", "model")``
CPU mesh (``launch.mesh.make_host_mesh(model=2)``), and
``launch.sharding.constrain`` redistributes a replicated DTensor under
``use_mesh``: each rank's shard is the slice numpy gives for its mesh
coordinate, a dimension the divisibility fallback replicates stays whole,
a rules table that replicates everything gathers the shards back, and a
plain tensor under the mesh raises.

Prints OK and exits 0; any failure exits non-zero.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def constrain_body() -> None:
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    mesh = mesh_lib.make_host_mesh(model=2, device="cpu")
    assert mesh.shape == {"data": 2, "model": 2}, mesh
    di, mi = mesh.device_mesh.get_coordinate()
    x = np.random.default_rng(7).normal(size=(8, 6, 5)).astype(np.float32)
    full = distribute_tensor(torch.from_numpy(x), mesh.device_mesh,
                             [Replicate(), Replicate()])
    with shd.use_mesh(mesh):
        # batch -> ("pod", "data") -> "data" here; mlp -> "model"; the
        # last dim's 5 does not divide "model"'s 2, so it stays whole
        y = shd.constrain(full, "batch", "mlp", None)
        assert np.array_equal(y.to_local().numpy(),
                              x[di * 4:(di + 1) * 4, mi * 3:(mi + 1) * 3])
        z = shd.constrain(full, "batch", None, "mlp")
        assert tuple(z.to_local().shape) == (4, 6, 5)
        assert np.array_equal(z.to_local().numpy(), x[di * 4:(di + 1) * 4])
        # a plain tensor under a mesh of four ranks raises
        try:
            shd.constrain(torch.from_numpy(x), "batch", "mlp", None)
        except NotImplementedError:
            pass
        else:
            raise AssertionError("a plain tensor under the mesh passed")
    with shd.use_mesh(mesh, {"batch": None, None: None}):
        back = shd.constrain(y, "batch", "mlp", None)
        assert np.array_equal(back.to_local().numpy(), x)


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    if sys.argv[4:] == ["constrain"]:
        try:
            constrain_body()
            dist.barrier()
        finally:
            dist.destroy_process_group()
        print("OK")
        return 0
    # the engine's modules only where they run (the constrain ranks start
    # sooner without them)
    from repro_torch.data.vectors import make_sift_like
    from repro_torch.engine import EngineConfig, SearchEngine, ShardedEngine
    try:
        ds = make_sift_like(n=2400, nt=1200, nq=6, d=32, ncl=16, seed=3,
                            device="cpu")
        cfg = EngineConfig(nprobe=2, rerank_mult=4, scan_impl="stream",
                           rerank_impl="stream")
        member = np.random.default_rng(4).random((3, 16)) < 0.5
        eng = SearchEngine.build(ds.train, ds.base, m=8, nlist=16,
                                 config=cfg, coarse_iters=4, pq_iters=4,
                                 device="cpu")
        eng = SearchEngine(eng.index, base=eng.base, config=cfg,
                           namespaces=member)
        sh = ShardedEngine(eng, world)
        group = dist.group.WORLD
        ns = np.array([-1, 0, 1, 2, 0, -1], np.int32)

        def agree(tag):
            # a filter as wide as the current cap (an upsert may grow it)
            fb = torch.from_numpy(np.random.default_rng(5).integers(
                0, 256, (16, (sh.cap + 7) // 8), dtype=np.uint8))
            for kw in ({}, {"filter_bits": fb}, {"namespaces": ns}):
                a = sh.search(ds.queries, 10, group=group, **kw)
                b = sh.search(ds.queries, 10, **kw)
                assert torch.equal(a.dists, b.dists), (tag, kw)
                assert torch.equal(a.ids, b.ids), (tag, kw)
                for x, y in zip(a.stats, b.stats):
                    assert torch.equal(x, y), (tag, kw)

        agree("pristine")
        rng = np.random.default_rng(41)
        assert sh.delete(rng.choice(2400, size=160, replace=False)) == 160
        agree("deleted")
        sh.upsert(np.arange(2400, 2500),
                  rng.normal(size=(100, 32)).astype(np.float32) * 64)
        agree("upserted")
        assert sh.compact() == 160
        agree("compacted")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
