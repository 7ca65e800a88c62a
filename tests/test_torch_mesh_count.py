"""The per-device count of a serving cell over a mesh
(``launch.cost_analysis`` over DTensors, ``launch.dryrun.count_mesh_cell``
on a fake process group of the mesh's ranks) and K8's sub-space mode
(``pq_decode_scores``, ``pq_decode_values``) in their plain versions.

- The counter over DTensors: a DTensor ``mm`` counts its local product's
  FLOPs and bytes whether DTensor's sharding propagator ran for it in the
  count (a fresh op signature) or before it (a cached one).
- The collectives of the smoke cells on a fake (2, 2) and (1, 4) group:
  the counter's kinds and counts equal ``CommDebugMode``'s, and the wire
  bytes are the result bytes times the reference's ring factors.
- Per-device dot FLOPs on a (2, 2) and, in the rules' head_dim branch, a
  (1, 4) mesh, and of the recurrent archs on both, against the
  reference's compiled per-device HLO's (``_torch_mesh_hlo_harness.py``,
  one subprocess of four forced host devices): equal; the head_dim
  branch's score all-reduces in the reference's type (bf16 in bf16).
- A full-width decode cell counted on the fake pod, its roofline and the
  report's columns; at one gloo rank a cell counts as the one-card count.
- K8's sub-space mode: the shards' plain scoring passes summed equal the
  whole LUT's i32 sums bit for bit, and the value passes' outputs,
  concatenated, ``pq_decode_plain(split=256)`` within tolerance; the
  port's rank body (``kvcache.subspace_rank``) run over the shards in
  lockstep as ``chip_smoke.py`` runs it on the card, the same.
"""
import importlib.util
import json
import math
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import report
from repro_torch.launch import roofline as rl

ROOT = pathlib.Path(__file__).resolve().parent.parent
META = torch.device("meta")


@pytest.fixture
def fake16():
    """A fake 16-rank group and a 1-D ``DeviceMesh`` over it."""
    with dryrun.fake_group(mesh_lib.Mesh({"data": 16})) as mesh:
        yield mesh.device_mesh


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("inner", [512, 384])
def test_a_dtensor_mm_counts_its_local_product(fake16, warm, inner):
    """(1024, inner) rows sharded 16 ways times a replicated (inner, 256):
    2 x 64 x inner x 256 FLOPs and the local operands' and output's bytes,
    on the first call of the signature in the count (``warm`` False: the
    propagator runs its global-shape meta products inside the count) and
    when a call before the count warmed DTensor's cache; a second count
    equals the first."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    a = DTensor.from_local(torch.empty((64, inner), device=META), fake16,
                           [Shard(0)], run_check=False)
    b = DTensor.from_local(torch.empty((inner, 256), device=META), fake16,
                           [Replicate()], run_check=False)
    if warm:
        torch.mm(a, b)
    counts = [ca.count(lambda: torch.mm(a, b), live=(a, b))[1]
              for _ in range(2)]
    for c in counts:
        assert c.flops == c.matmul_flops == 2 * 64 * inner * 256
        assert c.op_bytes == 4 * (64 * inner + inner * 256 + 64 * 256)
        assert c.ops == {"mm": 1} and c.wire_bytes == 0
        assert c.peak_live_bytes == c.op_bytes


def test_a_collective_counts_its_result_and_wire_bytes(fake16):
    """A Shard(0) DTensor made whole: one all-gather of its full bytes,
    wire = bytes x the reference's all-gather factor; a sum over the
    group: one all-reduce at factor 2; neither is an HBM op."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    x = DTensor.from_local(torch.empty((8, 32), device=META), fake16,
                           [Shard(0)], run_check=False)
    _, c = ca.count(lambda: x.redistribute(fake16, [Replicate()]))
    assert c.collective_ops == {"all-gather": 1}
    assert c.collective_bytes == {"all-gather": 128 * 32 * 4}
    assert c.wire_bytes == 128 * 32 * 4 * rl.WIRE_FACTOR["all-gather"]
    assert c.op_bytes == 0 and c.launches == 0
    _, c = ca.count(lambda: x.sum(0).redistribute(fake16, [Replicate()]))
    assert c.collective_ops == {"all-reduce": 1}
    assert c.wire_bytes == 32 * 4 * 2.0
    assert rl.WIRE_FACTOR == {"all-gather": 1.0, "all-reduce": 2.0,
                              "reduce-scatter": 1.0, "all-to-all": 1.0,
                              "collective-permute": 1.0}


def _comm_kind(op) -> str:
    return ca.COLLECTIVES[str(op).split(".")[-1]]


@pytest.mark.parametrize("model", [2, 4])
@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_collectives_equal_comm_debug_modes(model, kind):
    """qwen3-smoke's exact cell (B 4, 64 positions) on a fake (4 / model,
    model) group: the counter's collectives, by kind and count, equal
    ``CommDebugMode``'s over the same step, and the wire bytes are the
    sum of each kind's result bytes times its factor."""
    from torch.distributed.tensor.debug import CommDebugMode
    cfg = configs.get_smoke_config("qwen3-1.7b")
    desc = mesh_lib.Mesh({"data": 4 // model, "model": model})
    rules = dryrun.cell_rules(cfg, f"{kind}_32k", desc)
    with dryrun.fake_group(desc) as mesh:
        costs = dryrun.count_mesh_cell(cfg, kind, 4, 64, mesh, rules)
        trees = dryrun.mesh_trees(cfg, kind, 4, 64)
        inputs = trees["batch"][0]
        cell = dryrun.mesh_cell(cfg, kind, mesh, rules, trees["param"][0],
                                tokens=inputs["tokens"],
                                cache=trees.get("cache", (None,))[0],
                                position=inputs.get("position"), max_seq=64)
        with CommDebugMode() as cm:
            cell.step()
    want = {}
    for op, n in cm.get_comm_counts().items():
        if n:
            want[_comm_kind(op)] = want.get(_comm_kind(op), 0) + n
    assert costs.collective_ops == want and want
    assert costs.wire_bytes == sum(
        b * rl.WIRE_FACTOR[k] for k, b in costs.collective_bytes.items())


# arch:kind:batch:seq:mesh[:heads[:dtype]]; 6 heads over a model axis of
# 4: the rules' head_dim branch, also at two attention chunks in bf16; the
# recurrent archs (zamba2's exact cache) on both meshes
CELLS = ("qwen3-1.7b:decode:4:64:2x2", "qwen3-1.7b:prefill:4:32:2x2",
         "dbrx-132b:decode:4:64:2x2", "qwen3-1.7b:decode:4:64:1x4:6",
         "qwen3-1.7b:prefill:4:32:1x4:6",
         "qwen3-1.7b:prefill:4:64:1x4:6:bfloat16",
         *(f"{arch}:{kind}:4:{seq}:{mesh}"
           for arch in ("zamba2-2.7b", "rwkv6-3b")
           for kind, seq in (("decode", 64), ("prefill", 32))
           for mesh in ("2x2", "1x4")))
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _skipped_blocks(cfg, seq: int) -> int:
    """The causal blocks past the frontier that the port's chunked
    attention skips and the reference's analyzer counts (both branches of
    its ``lax.cond``), over the layers."""
    nq, nkv = seq // cfg.attn_q_chunk, seq // cfg.attn_kv_chunk
    if nq <= 1:
        return 0
    live = sum(1 for i in range(nq) for j in range(nkv)
               if j * cfg.attn_kv_chunk < (i + 1) * cfg.attn_q_chunk)
    return cfg.n_layers * (nq * nkv - live)


def _numel(hlo_type: str) -> int:
    """The elements of an HLO array type (0 for a tuple)."""
    m = re.fullmatch(r"\w+\[([\d,]*)\]", hlo_type)
    return math.prod(int(d) for d in m.group(1).split(",") if d) if m else 0


def test_per_device_dot_flops_equal_the_references_compiled_hlo(
        monkeypatch):
    """The reference's decode and prefill cells of qwen3-smoke and dbrx-
    smoke on a (2, 2) mesh, of qwen3-smoke with 6 heads on a (1, 4) mesh
    (the rules' head_dim branch; its prefill also at two attention
    chunks in bf16), and of zamba2-smoke and rwkv6-smoke on both,
    compiled on four forced host devices (``_torch_mesh_hlo_harness.py``,
    one subprocess): each one's per-device dot FLOPs equal the port's
    per-device matmul FLOPs on a fake group of the same shape at the
    tolerance of ``test_torch_dryrun.py``'s one-card comparison (0.2%),
    less exactly the causal blocks the port skips where there are two
    chunks. In the head_dim branch's prefill the attention runs on each
    rank's head_dim slice (``layers._over_head_dim``), so its ``bmm`` is
    a quarter of the one-card count, as XLA's, and each block's partial
    scores are all-reduced in the type and shape of the reference's after
    SPMD partitioning (bf16 in the bf16 cell: the CPU backend widens it to
    f32 later), once a live block. The other collectives differ in kind
    (XLA's own partitioner and fusions) and are printed side by side, not
    held."""
    from repro_torch.launch import sharding as shd
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               REPRO_XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    # the reference compiles in its own process while this one counts
    proc = subprocess.Popen([sys.executable, str(
        ROOT / "tests" / "_torch_mesh_hlo_harness.py"), *CELLS],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
    real_all_reduce, psums = shd.all_reduce, []

    def all_reduce(t, *args, **kwargs):
        psums.append((t.dtype, t.numel()))
        return real_all_reduce(t, *args, **kwargs)

    monkeypatch.setattr(shd, "all_reduce", all_reduce)
    try:
        counted = []
        for spec in CELLS:
            arch, kind, b, s, shape, *variant = spec.split(":")
            cfg = configs.get_smoke_config(arch).replace(kv_pq=False)
            if variant:
                cfg = cfg.replace(n_heads=int(variant[0]))
            if len(variant) > 1:
                cfg = cfg.replace(dtype=variant[1])
            d, m = (int(n) for n in shape.split("x"))
            desc = mesh_lib.Mesh({"data": d, "model": m})
            psums.clear()
            c = dryrun.count_mesh_cell(cfg, kind, int(b), int(s), desc,
                                       dryrun.serving_rules(cfg, desc))
            one = None
            if variant and kind == "prefill":
                one = dryrun.count_cell(cfg, kind, int(b), int(s))
            counted.append((cfg, c, one, m, list(psums)))
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    refs = [json.loads(line) for line in out.splitlines()]
    for spec, ref, (cfg, c, one, m, psum) in zip(CELLS, refs, counted,
                                                 strict=True):
        part = ref["partitioned"]
        print(f"{spec}: dot FLOPs a device {c.matmul_flops:.0f} (reference "
              f"{ref['dot_flops']:.0f}); collectives {c.collective_ops} "
              f"{c.wire_bytes:.0f} wire B (reference {ref['ops']} "
              f"{ref['wire']:.0f}, {part['wire']:.0f} at the partitioner's "
              f"types)")
        b, s = (int(n) for n in spec.split(":")[2:4])
        skipped = _skipped_blocks(cfg, s) if one is not None else 0
        if one is not None:
            assert c.flops_by_op["bmm"] == one.flops_by_op["bmm"] / m
            block = (b * cfg.n_kv_heads * cfg.n_heads // cfg.n_kv_heads
                     * cfg.attn_q_chunk * cfg.attn_kv_chunk)
            scores = {t: n for t, n in part["all_reduces"].items()
                      if _numel(t) == block}
            (ref_type, ref_n), = scores.items()
            got = [dt for dt, n in psum if n == block]
            assert set(got) == {_DTYPES[ref_type.split("[")[0]]}, (
                spec, got, ref_type)
            assert len(got) == ref_n - skipped, (spec, len(got), ref_n)
            skipped *= (4 * b * cfg.attn_q_chunk * cfg.attn_kv_chunk
                        * cfg.n_heads * cfg.resolved_head_dim // m)
        assert c.matmul_flops + skipped == pytest.approx(ref["dot_flops"],
                                                         rel=2e-3)


def test_a_full_width_decode_cell_on_the_fake_pod(tmp_path):
    """qwen3-1.7b decode_32k on the (16, 16) pod: counted per device, its
    roofline of 256 chips from the counts; per-device matmul FLOPs x 256
    above the one-card count by exactly the replicated K/V projections
    (8 KV heads do not divide the 16-wide model axis, so each model rank
    projects all of them: 15 copies too many, 1.32x the step's matmul
    FLOPs); collectives all-reduce and all-gather with wire bytes, both
    report tables' columns; a process group initialized already is
    refused."""
    r = dryrun.run_cell("qwen3-1.7b", "decode_32k", mesh="pod",
                        out_dir=str(tmp_path), verbose=False)
    assert r["status"] == "ok" and r["counted"] == dryrun.COUNTED_PER_DEVICE
    roof, coll = r["roofline"], r["collectives"]
    assert roof["chips"] == 256 and roof["hlo_flops_per_dev"] == r["flops"]
    assert roof["hlo_bytes_per_dev"] == r["min_bytes"] > 0
    assert roof["wire_bytes_per_dev"] == coll["wire_bytes_per_dev"] > 0
    assert set(coll["ops"]) == {"all-reduce", "all-gather"}
    assert roof["collectives"] == coll["ops"]
    assert r["peak_live_bytes"] <= rl.HBM_BYTES and r["launches"] > 0
    cfg = configs.get_config("qwen3-1.7b")
    one = dryrun.count_cell(cfg, "decode", 128, 32768)
    kv_proj = (2 * 128 * cfg.d_model * 2 * cfg.n_kv_heads
               * cfg.resolved_head_dim * cfg.n_layers)
    assert r["matmul_flops"] * 256 == pytest.approx(
        one.matmul_flops + 15 * kv_proj, rel=1e-9)
    cells = report.load_cells(str(tmp_path))
    row = report.per_device_table(cells).splitlines()[2]
    assert f"| {r['flops']:.3e} |" in row and roof["bottleneck"] in row
    assert "all-gather 57" in report.dryrun_table(cells)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="initialized already"):
            dryrun.count_mesh_cell(configs.get_smoke_config("qwen3-1.7b"),
                                   "decode", 4, 64,
                                   mesh_lib.Mesh({"data": 1, "model": 2}),
                                   dict(dryrun.shd.DEFAULT_RULES))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("pq", [False, True])
def test_at_one_gloo_rank_a_cell_counts_as_one_card(pq):
    """qwen3-1.7b's decode at B 8 x 4,096 over a (1, 1) gloo mesh: the
    matmul FLOPs, the compulsory bytes and the peak of live bytes equal
    the one-card count's, no wire bytes, K8 launched a layer with the PQ
    cache; the FLOPs differ only by the placed write's index arithmetic
    (3 elementwise ops of one element a layer)."""
    cfg = configs.get_config("qwen3-1.7b").replace(kv_pq=pq)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(device="cpu")
        got = dryrun.count_mesh_cell(cfg, "decode", 8, 4096, mesh,
                                     dryrun.cell_rules(cfg, "decode_32k",
                                                       mesh))
    finally:
        dist.destroy_process_group()
    want = dryrun.count_cell(cfg, "decode", 8, 4096)
    assert got.matmul_flops == want.matmul_flops
    assert got.min_bytes == want.min_bytes
    assert got.peak_live_bytes == want.peak_live_bytes
    assert got.wire_bytes == 0 and got.collective_ops == {}
    assert got.kernels == want.kernels
    assert 0 <= got.flops - want.flops <= 3 * cfg.n_layers


@pytest.mark.parametrize("arch, pq", [("zamba2-2.7b", True),
                                      ("rwkv6-3b", False)])
def test_at_one_gloo_rank_a_recurrent_cell_counts_as_one_card(arch, pq):
    """zamba2-2.7b's PQ decode (its CONFIG's) and rwkv6-3b's at B 8 x
    4,096 over a (1, 1) gloo mesh: the matmul FLOPs, the compulsory bytes
    (each state read and written whole, ``decode_cache_bytes`` on the
    local shards) and the peak of live bytes equal the one-card count's,
    K8 launched once a shared-attention group, no wire bytes; the FLOPs
    differ only by the placed writes' index arithmetic (3 a group)."""
    cfg = configs.get_config(arch).replace(kv_pq=pq)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = mesh_lib.make_host_mesh(device="cpu")
        got = dryrun.count_mesh_cell(cfg, "decode", 8, 4096, mesh,
                                     dryrun.cell_rules(cfg, "decode_32k",
                                                       mesh))
    finally:
        dist.destroy_process_group()
    want = dryrun.count_cell(cfg, "decode", 8, 4096)
    groups = cfg.n_layers // cfg.shared_attn_every if pq else 0
    assert got.matmul_flops == want.matmul_flops
    assert got.min_bytes == want.min_bytes
    assert got.peak_live_bytes == want.peak_live_bytes
    assert got.wire_bytes == 0 and got.collective_ops == {}
    assert got.kernels == want.kernels == (
        {"pq_decode_attention": groups} if pq else {})
    assert got.flops - want.flops == 3 * groups


@pytest.mark.parametrize("shape", [(2, 4), (4, 4)])
def test_a_moe_prefill_under_fsdp_rules_counts_on_a_fake_mesh(shape):
    """dbrx-smoke's prefill on a fake (data, 4) group under rules that keep
    "embed" on "data" (the pod's FSDP serving, as dbrx-132b's
    prefill_32k): DTensor shards the KV projection's flattened (2 heads
    x 16) columns over the 4-wide model axis, which the view to (heads,
    head_dim) cannot keep; ``layers.project`` takes them whole there, so
    the cell runs and counts its collectives."""
    cfg = configs.get_smoke_config("dbrx-132b")
    desc = mesh_lib.Mesh({"data": shape[0], "model": shape[1]})
    rules = {**dryrun.serving_rules(cfg, desc), "embed": "data"}
    c = dryrun.count_mesh_cell(cfg, "prefill", 8, 64, desc, rules)
    assert c.matmul_flops > 0 and c.collective_ops["all-reduce"] == 5


def test_pod_cells_that_run_no_step_over_ranks_say_what_is_left():
    """Training keeps ``roofline: null`` on the pod, its ``counted``
    naming ROADMAP Queue 1's item 6 alone (the recurrent families', item
    5, are counted now)."""
    for arch, shape in (("qwen3-1.7b", "train_4k"),
                        ("rwkv6-3b", "train_4k")):
        r = dryrun.run_cell(arch, shape, mesh="pod", verbose=False)
        assert r["roofline"] is None
        assert r["counted"] == dryrun.COUNTED_ON_A_MESH
        assert "item 6" in r["counted"] and "item 5" not in r["counted"]
    assert "item 6" in dryrun.shd.NEXT_SLICE
    assert "item 5" not in dryrun.shd.NEXT_SLICE


# ---------------------------------------------------------------------------
# K8's sub-space mode, plain
# ---------------------------------------------------------------------------

def _subspace_inputs(cb_dtype, seed: int = 0):
    from repro_torch.models import kvcache as kvc
    g = torch.Generator().manual_seed(seed)
    b, smax, kv, gq, m, dsub = 3, 1024, 2, 3, 16, 2
    q = torch.randn((b, kv * gq, m * dsub), generator=g)
    k_cb, v_cb = (torch.randn((kv, m, 16, dsub), generator=g).to(cb_dtype)
                  for _ in range(2))
    table, scale, bias = kvc._luts(q.reshape(b, kv, gq, -1), k_cb, True)
    codes = [torch.randint(0, 256, (b, smax, kv, m // 2), generator=g,
                           dtype=torch.uint8) for _ in range(2)]
    # a row live in the first split only, one to a split's boundary, one
    # whole
    position = torch.tensor([5, 511, smax - 1], dtype=torch.int32)
    return table, scale, bias, codes, v_cb, position, (q, k_cb)


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("cb_dtype", [torch.bfloat16, torch.float32])
def test_k8_subspace_mode_plain_is_the_one_rank_split_order(n, cb_dtype):
    """M 16 over n shards of M / n sub-spaces: the shards' plain scoring
    passes summed equal the whole table's i32 sums bit for bit (0 at dead
    positions), so the scores are the one-rank K8's; each shard's value
    pass over the whole sums and its codebook slice, combined, gives its
    head_dim slice, and the slices concatenated equal
    ``pq_decode_plain(split=256)`` within 1e-6 of each row's largest
    |value| (the value sums walk a slice's dims: another product
    shape)."""
    table, scale, bias, (kc, vc), v_cb, position, _ = _subspace_inputs(
        cb_dtype)
    m = table.shape[3]
    ml = m // n
    shards = [slice(r * ml, (r + 1) * ml) for r in range(n)]
    sums = sum(pqk.pq_decode_scores(
        table[..., sl, :].contiguous(), kc[..., sl.start // 2:sl.stop // 2]
        .contiguous(), position) for sl in shards)
    want = pqk.plain_scores(table, kc, position)
    assert sums.dtype == torch.int32 and torch.equal(sums, want)
    live = torch.arange(kc.shape[1])[None] <= position[:, None]
    assert torch.equal(want, torch.where(
        live[:, None, None], pqk.adc_sums(table, kc), 0))
    outs = [pqk.pq_decode_combine(pqk.pq_decode_values(
        sums, scale, bias, vc[..., sl.start // 2:sl.stop // 2].contiguous(),
        v_cb[:, sl].contiguous(), position), out_dtype=torch.float32)
        for sl in shards]
    got = torch.cat(outs, dim=-1)
    ref = pqk.pq_decode_plain(table, scale, bias, kc, vc, v_cb, position,
                              chunk=1024, out_dtype=torch.float32,
                              split=pqk.SPLIT)
    row = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    assert float(((got - ref).abs() / row).max()) <= 1e-6
    if n == 1:
        assert torch.equal(got, ref)


@pytest.mark.parametrize("n", [2, 4])
def test_k8_subspace_rank_in_lockstep_is_the_one_rank_k8(n):
    """``kvcache.subspace_rank`` over n shards of M 16, each given views of
    its head_dim slice of q and its sub-spaces, run in lockstep with the
    collectives done across the shards (``chip_smoke.in_lockstep``, its
    check of the card's sub-space mode): the all-reduced i32 sums equal
    the whole table's plain sums bit for bit, the MAX-reduced range gives
    the one-rank scale and the gathered biases its summed bias, and the
    concatenated slices equal ``pq_decode_plain(split=256)`` within 1e-6
    of each row's largest |value|."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.models import kvcache as kvc
    table, scale, bias, (kc, vc), v_cb, position, (q, k_cb) = \
        _subspace_inputs(torch.float32)
    m, hd = table.shape[3], q.shape[-1]
    ml, dl = m // n, hd // n
    outs, seen = smoke.in_lockstep(torch, [kvc.subspace_rank(
        q[..., r * dl:(r + 1) * dl], kc[..., r * ml // 2:(r + 1) * ml // 2],
        vc[..., r * ml // 2:(r + 1) * ml // 2], k_cb[:, r * ml:(r + 1) * ml],
        v_cb[:, r * ml:(r + 1) * ml], position, hd) for r in range(n)])
    assert list(seen) == ["max", "gather", "sum"]
    assert torch.equal(seen["sum"], pqk.plain_scores(table, kc, position))
    assert torch.equal(torch.clamp_min(seen["max"], 1e-20) / 255.0, scale)
    assert torch.equal(seen["gather"].sum(-1), bias)
    got = torch.cat(outs, dim=-1)
    ref = pqk.pq_decode_plain(table, scale, bias, kc, vc, v_cb, position,
                              chunk=1024, out_dtype=torch.float32,
                              split=pqk.SPLIT)
    row = ref.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    assert got.shape == ref.shape
    assert float(((got - ref).abs() / row).max()) <= 1e-6


def test_k8_subspace_mode_meta_records_one_launch_a_pass():
    """On meta each pass records one launch of its ``roofline`` cost: the
    scoring pass's live codes, LUTs, positions and whole i32 output; the
    value pass's live sums and V codes, its codebook slice and its split
    partials; nothing else is counted. The arguments are checked."""
    b, kv, g, m, dsub, smax = 8, 8, 2, 16, 2, 1024
    table = torch.empty((b, kv, g, m, 16), dtype=torch.uint8, device=META)
    codes = torch.empty((b, smax, kv, m // 2), dtype=torch.uint8,
                        device=META)
    pos = torch.empty((b,), dtype=torch.int32, device=META)
    scale = torch.empty((b, kv, g), device=META)
    cb = torch.empty((kv, m, 16, dsub), dtype=torch.bfloat16, device=META)

    def both():
        sums = pqk.pq_decode_scores(table, codes, pos)
        return sums, pqk.pq_decode_values(sums, scale, scale, codes, cb, pos)

    before = pqk.launches
    (sums, work), c = ca.count(both, live_positions=700)
    assert pqk.launches == before
    assert sums.dtype == torch.int32 and tuple(sums.shape) == (b, kv, g, smax)
    assert tuple(work.shape) == (b, kv, g, 4, m * dsub + 2)
    assert c.kernels == {"pq_decode_scores": 1, "pq_decode_values": 1}
    heads = kv * g
    nbytes, ops, peak = rl.kernel_cost("pq_decode_scores", b=b, kv=kv, g=g,
                                       m=m, smax=smax, live=700)
    assert c.bytes_by_op["pq_decode_scores"] == nbytes == (
        b * 700 * kv * (m // 2) + b * heads * m * 16 + 4 * b
        + b * heads * smax * 4)
    assert ops == b * heads * 700 * m * 2 and peak == rl.PEAK_INT8_OPS
    hd = m * dsub
    nbytes, ops, peak = rl.kernel_cost("pq_decode_values", b=b, kv=kv, g=g,
                                       m=m, head_dim=hd, live=700, nsplit=4)
    assert c.bytes_by_op["pq_decode_values"] == nbytes == (
        b * 700 * heads * 4 + b * 700 * kv * (m // 2) + 8 * b * heads
        + kv * m * 16 * dsub * 2 + 4 * b
        + heads * b * (3 * (hd + 2) * 4 + 8))
    assert ops == b * heads * 700 * hd * 2 and peak == rl.PEAK_F32_FLOPS
    with pytest.raises(ValueError, match="k_codes"):
        pqk.pq_decode_scores(table, codes[..., :2].contiguous(), pos)
    with pytest.raises(ValueError, match="do not match"):
        pqk.pq_decode_values(sums, scale, scale,
                             codes[..., :2].contiguous(), cb, pos)
    with pytest.raises(ValueError):
        pqk.pq_decode_values(sums.float(), scale, scale, codes, cb, pos)
