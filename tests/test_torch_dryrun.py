"""The port's dry-run over one H100 (``repro_torch.launch.dryrun``,
``cost_analysis``, ``roofline``, ``report``) against the reference's
launch tools, on the CPU.

The model-FLOP accounting and the roofline's arithmetic equal the
reference's; the op counter holds on hand cases; its matmul FLOPs of a
step equal the dot FLOPs of the reference's compiled step (its own HLO
analyzer) on smoke configs; K8's meta branch records one launch a PQ
attention layer; ``kernel_cost`` gives PERF.md's bound column; full cells
run on the meta device; and the launchers' ``--dry-run`` loads no jax.
The new modules import neither jax nor the JAX package (checked in a fresh
interpreter by ``test_torch_core.py``'s import test and here).
"""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro import configs as rconfigs
from repro.launch import hlo_analysis as rha
from repro.launch import roofline as rrl
from repro.models import model as rmodel
from repro.train import optimizer as ropt
from repro.train import train_loop as rtl
from repro_torch import configs
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun
from repro_torch.launch import report
from repro_torch.launch import roofline as rl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = list(configs.ALIASES)
META = torch.device("meta")


# ---------------------------------------------------------------------------
# model FLOPs, parameter counts, the roofline's arithmetic
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_and_param_counts_equal_the_reference(arch, kind):
    ours, ref = configs.get_config(arch), rconfigs.get_config(arch)
    assert ours.param_count() == ref.param_count()
    assert ours.active_param_count() == ref.active_param_count()
    for batch, seq in ((1, 128), (8, 2048), (256, 4096)):
        assert rl.model_flops(ours, kind, batch, seq) == \
            rrl.model_flops(ref, kind, batch, seq)


ROOFLINE_CASES = [
    dict(hlo_flops_per_dev=2.5e14, hlo_bytes_per_dev=4e10,
         wire_bytes_per_dev=0.0, model_flops_total=2.1e14, chips=1),
    dict(hlo_flops_per_dev=3.7e10, hlo_bytes_per_dev=6e9,
         wire_bytes_per_dev=0.0, model_flops_total=3.6e10, chips=1),
    dict(hlo_flops_per_dev=1e12, hlo_bytes_per_dev=1e9,
         wire_bytes_per_dev=5e11, model_flops_total=8e11, chips=4),
    dict(hlo_flops_per_dev=0.0, hlo_bytes_per_dev=0.0,
         wire_bytes_per_dev=0.0, model_flops_total=0.0, chips=1),
]


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_is_the_references_with_the_h100s_peaks(monkeypatch, case):
    kw = dict(ROOFLINE_CASES[case], arch="a", shape="s", mesh="m",
              collectives={})
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(rrl, name, getattr(rl, name))
    assert rl.Roofline(**kw).to_dict() == rrl.Roofline(**kw).to_dict()
    r = rl.Roofline(**kw)
    assert r.t_compute == kw["hlo_flops_per_dev"] / 989e12
    assert r.t_memory == kw["hlo_bytes_per_dev"] / 3.35e12
    assert r.t_collective == kw["wire_bytes_per_dev"] / 450e9


def test_the_h100s_peaks_are_named():
    assert rl.DEVICE == "NVIDIA H100 80GB HBM3" and rl.POWER_W == 700
    assert (rl.PEAK_FLOPS, rl.PEAK_INT8_OPS, rl.PEAK_F32_FLOPS, rl.HBM_BW,
            rl.LINK_BW, rl.HBM_BYTES) == (989e12, 1979e12, 67e12, 3.35e12,
                                          450e9, 80 * 10**9)


# ---------------------------------------------------------------------------
# the counter on hand cases
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_counter_matmul(dtype):
    m, k, n = 48, 80, 112
    a = torch.empty((m, k), dtype=dtype, device=META)
    b = torch.empty((k, n), dtype=dtype, device=META)
    _, c = ca.count(lambda: a @ b)
    size = torch.empty((), dtype=dtype).element_size()
    assert c.flops == 2 * m * k * n == c.matmul_flops
    assert c.op_bytes == (m * k + k * n + m * n) * size
    assert c.ops == {"mm": 1}


def test_counter_views_cost_nothing():
    x = torch.empty((4, 6, 8), device=META)
    _, c = ca.count(lambda: x.view(24, 8)[2:10].t().unsqueeze(0)
                    .expand(3, 8, 8).select(0, 1).permute(1, 0)
                    .transpose(0, 1).squeeze().detach())
    assert (c.flops, c.op_bytes, c.launches) == (0.0, 0.0, 0)


def test_counter_elementwise_is_one_flop_an_element():
    x = torch.empty((32, 64), device=META)
    y = torch.empty((64,), device=META)
    _, c = ca.count(lambda: torch.exp(x + y))
    assert c.flops == 2 * 32 * 64
    # x read, y broadcast read once, each output written
    assert c.op_bytes == 4 * (32 * 64 + 64 + 32 * 64) + 4 * (32 * 64 * 2)
    assert c.ops == {"add": 1, "exp": 1}


@pytest.mark.parametrize("layers", [1, 3, 7])
def test_counter_counts_each_of_l_identical_layers(layers):
    """The trip-count analogue: a Python loop over L layers is L times one
    layer."""
    w = [torch.empty((64, 64), device=META) for _ in range(layers)]
    x = torch.empty((16, 64), device=META)

    def stack(n):
        h = x
        for i in range(n):
            h = torch.tanh(h @ w[i])
        return h

    _, one = ca.count(stack, 1)
    _, many = ca.count(stack, layers)
    assert many.flops == layers * one.flops
    assert many.op_bytes == layers * one.op_bytes
    assert many.launches == layers * one.launches


def test_counter_counts_the_remat_recompute_once():
    """``torch.utils.checkpoint`` adds exactly one recompute of the
    checkpointed forward, counted in the backward where it runs (the
    reference's test_analyzer_remat_counts_recompute)."""
    def run(remat):
        w = torch.empty((64, 64), device=META, requires_grad=True)
        x = torch.empty((32, 64), device=META)

        def f(w, x):
            return torch.tanh(x @ w)

        def step():
            h = (checkpoint(f, w, x, use_reentrant=False) if remat
                 else f(w, x))
            h.sum().backward()
        return ca.count(step)[1]

    def fwd():
        w = torch.empty((64, 64), device=META)
        x = torch.empty((32, 64), device=META)
        return ca.count(lambda: torch.tanh(x @ w))[1]

    plain, remat, forward = run(False), run(True), fwd()
    assert remat.flops == plain.flops + forward.flops
    assert remat.matmul_flops == plain.matmul_flops + 2 * 32 * 64 * 64
    assert remat.ops["mm"] == plain.ops["mm"] + 1


def test_counter_counts_the_cpu_and_meta_alike():
    def step(dev):
        g = torch.Generator().manual_seed(0)
        w = torch.randn((64, 96), generator=g).to(dev).requires_grad_()
        x = torch.randn((8, 64), generator=g).to(dev)
        idx = torch.tensor([3, 1, 4, 1, 5]).to(dev)
        rows = torch.tensor([0, 2]).to(dev)

        def fn():
            h = torch.softmax(x @ w, -1)[idx]
            h = h.index_copy(0, rows, h[:2] * 2)
            h.sum().backward()
        return ca.count(fn, live=(w, x))[1]

    cpu, meta = step("cpu"), step(META)
    for field in ("flops", "op_bytes", "ops", "flops_by_op", "bytes_by_op",
                  "peak_live_bytes"):
        assert getattr(cpu, field) == getattr(meta, field), field


def test_counter_tracks_live_storages():
    x = torch.empty((1024,), device=META)

    def fn():
        a = x * 2                      # 4 KiB
        b = a + 1                      # 8 KiB live
        del a
        c = b * 3                      # 8 KiB live (a freed)
        return c

    _, c = ca.count(fn, live=(x,))
    assert c.peak_live_bytes == 3 * 4096


def test_gathers_and_scatters_cost_their_rows():
    table = torch.empty((1000, 64), device=META)
    idx = torch.empty((8,), dtype=torch.int64, device=META)
    _, g = ca.count(lambda: table[idx])
    assert g.op_bytes == 2 * 8 * 64 * 4 + 8 * 8
    cache = torch.empty((4, 4096, 2, 16), device=META)
    new = torch.empty((4, 1, 2, 16), device=META)
    pos = torch.empty((1,), dtype=torch.int64, device=META)
    _, s = ca.count(lambda: cache.index_copy_(1, pos, new))
    assert s.op_bytes == 2 * 4 * 2 * 16 * 4 + 8


# ---------------------------------------------------------------------------
# against the reference's compiled steps
# ---------------------------------------------------------------------------

class _DotFlops(rha.HloAnalyzer):
    """The reference's analyzer counting its dots only: a fusion's FLOPs
    are its body's, without the 1-per-element charge."""

    def _instr_flops(self, comp, ins):
        if ins.op == "fusion":
            mc = rha._CALLS_RE.search(ins.rest)
            return self.flops(mc.group(1)) if mc else 0.0
        return super()._instr_flops(comp, ins)


def _reference_dot_flops(arch: str, kind: str, batch: int, seq: int) -> float:
    cfg = rconfigs.get_smoke_config(arch).replace(kv_pq=False)
    params = rmodel.lm_shapes(cfg)
    if kind == "train":
        step = rtl.make_train_step(cfg, ropt.AdamWConfig(total_steps=1000), 1)
        sds = jax.ShapeDtypeStruct
        batch_sds = {"tokens": sds((batch, seq), jnp.int32),
                     "targets": sds((batch, seq), jnp.int32),
                     "mask": sds((batch, seq), jnp.float32)}
        lowered = jax.jit(step).lower(
            rtl.TrainState(params, ropt.state_shapes(params), None), batch_sds)
    else:
        lowered = jax.jit(lambda p, t: rmodel.prefill(p, t, cfg, max_seq=seq)
                          ).lower(params, jax.ShapeDtypeStruct((batch, seq),
                                                               jnp.int32))
    analyzer = _DotFlops(lowered.compile().as_text())
    assert rha.analyze_hlo(lowered.compile().as_text()).flops > 0
    return analyzer.flops(analyzer.entry)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b", "zamba2-2.7b",
                                  "rwkv6-3b"])
def test_train_matmul_flops_equal_the_references_dots(arch):
    """At S = one attention chunk (no causal block to skip) the port's
    counted matmul FLOPs of a train step equal the dots of the reference's
    compiled step. Tolerance 0.2%: XLA rewrites a few small dots of the
    recurrent scans' backward (zamba2's SSD 0.11% under the port's count,
    rwkv6's WKV 0.03% over it); the dense and MoE steps are equal."""
    cfg = configs.get_smoke_config(arch).replace(kv_pq=False)
    ours = dryrun.count_cell(cfg, "train", 2, 32).matmul_flops
    ref = _reference_dot_flops(arch, "train", 2, 32)
    assert ours == pytest.approx(ref, rel=2e-3)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "dbrx-132b", "zamba2-2.7b",
                                  "rwkv6-3b"])
def test_prefill_matmul_flops_against_the_references_dots(arch):
    """At S = two attention chunks the port's chunked attention never runs
    the block above the causal frontier; the reference's skips it in a
    ``lax.cond``, which its analyzer counts at the larger branch. So the
    port's count is the reference's less exactly those blocks' two
    products a layer (B x H x 32 x 32 x head_dim x 2 FLOPs each), and
    within 10% of it."""
    cfg = configs.get_smoke_config(arch).replace(kv_pq=False)
    ours = dryrun.count_cell(cfg, "prefill", 2, 64).matmul_flops
    ref = _reference_dot_flops(arch, "prefill", 2, 64)
    attn_layers = {"attn": cfg.n_layers, "rwkv6": 0,
                   "mamba2": cfg.n_layers // max(cfg.shared_attn_every, 1)
                   if cfg.shared_attn_every else 0}[cfg.block_type]
    skipped = attn_layers * 2 * (2 * 2 * cfg.n_heads * 32 * 32
                                 * (cfg.resolved_head_dim if cfg.n_heads
                                    else 0))
    assert ours + skipped == ref
    assert ours == pytest.approx(ref, rel=0.10)


# ---------------------------------------------------------------------------
# K8 on the meta device
# ---------------------------------------------------------------------------

def _k8_meta_args(b=8, smax=4096, kv=8, g=2, m=64, dsub=2, q8=True):
    def t(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=META)
    table = t((b, kv, g, m, 16), torch.uint8 if q8 else torch.float32)
    scale = t((b, kv, g), torch.float32) if q8 else None
    bias = t((b, kv, g), torch.float32) if q8 else None
    return (table, scale, bias, t((b, smax, kv, m // 2), torch.uint8),
            t((b, smax, kv, m // 2), torch.uint8),
            t((kv, m, 16, dsub), torch.bfloat16), t((b,), torch.int32))


@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_k8_meta_branch_records_its_cost(monkeypatch, q8, out_dtype):
    from repro_torch.kernels import _build

    def no_library():
        raise AssertionError("the meta branch loaded the library")

    monkeypatch.setattr(_build, "load_library", no_library)
    before = pqk.launches
    args = _k8_meta_args(q8=q8)
    out, c = ca.count(lambda: pqk.pq_decode(*args, chunk=2048,
                                            out_dtype=out_dtype),
                      live_positions=2111)
    assert out.device.type == "meta" and out.dtype == out_dtype
    assert out.shape == (8, 16, 128)          # (B, KV * g, head_dim)
    assert pqk.launches == before             # nothing was launched
    nbytes, ops, _ = rl.kernel_cost(
        "pq_decode_attention", b=8, kv=8, g=2, m=64, head_dim=128,
        live=2111, q8=q8, cb_itemsize=2, out_itemsize=out_dtype.itemsize)
    assert c.kernels == {"pq_decode_attention": 1}
    assert c.bytes_by_op["pq_decode_attention"] == nbytes
    assert c.flops_by_op["pq_decode_attention"] == ops
    # without a counter: all Smax positions, nothing recorded, no error
    assert pqk.pq_decode(*args, chunk=2048, out_dtype=out_dtype).is_meta


def test_k8_meta_branch_keeps_the_kernels_limits():
    with pytest.raises(ValueError, match="g=13"):
        pqk.pq_decode(*_k8_meta_args(kv=1, g=13), chunk=2048,
                      out_dtype=torch.bfloat16)
    # a shape whose split pass needs more shared memory than a block gets,
    # by the Python mirror
    from repro_torch.kernels import _build
    assert pqk.smem_bytes(12, 256, 256, False) > _build.SMEM_LIMIT
    with pytest.raises(ValueError, match="shared memory"):
        pqk.pq_decode(*_k8_meta_args(kv=1, g=12, m=256, dsub=1, q8=False),
                      chunk=2048, out_dtype=torch.bfloat16)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "zamba2-2.7b"])
def test_pq_decode_cell_records_k8_once_an_attention_layer(arch):
    cfg = configs.get_config(arch).replace(kv_pq=True)
    c = dryrun.count_cell(cfg, "decode", 8, 4096, live=2112)
    layers = (cfg.n_layers if cfg.block_type == "attn"
              else cfg.n_layers // cfg.shared_attn_every)
    assert c.kernels == {"pq_decode_attention": layers}
    assert c.ops["pq_decode_attention"] == layers


def test_the_cpu_still_takes_k8s_plain_version():
    g = torch.Generator().manual_seed(0)
    b, smax, kv, gg, m, dsub = 2, 64, 2, 2, 8, 2
    table = torch.randn((b, kv, gg, m, 16), generator=g)
    k = torch.randint(0, 256, (b, smax, kv, m // 2), generator=g,
                      dtype=torch.uint8)
    v = torch.randint(0, 256, (b, smax, kv, m // 2), generator=g,
                      dtype=torch.uint8)
    cb = torch.randn((kv, m, 16, dsub), generator=g)
    pos = torch.tensor([5, 40], dtype=torch.int32)
    out, c = ca.count(lambda: pqk.pq_decode(table, None, None, k, v, cb, pos,
                                            chunk=32,
                                            out_dtype=torch.float32))
    want = pqk.pq_decode_plain(table, None, None, k, v, cb, pos, chunk=32,
                               out_dtype=torch.float32)
    assert torch.equal(out, want) and "pq_decode_attention" not in c.ops


# ---------------------------------------------------------------------------
# kernel_cost against PERF.md's bound column
# ---------------------------------------------------------------------------

def _k1_shape():
    """K1's operands as chip_smoke.py's k1_phase draws them (seed 0 + 1)
    on the SIFT1M index (nlist 1024, cap 4096)."""
    cap, nlist, g, m, w = 4096, 1024, 1024, 16, 512
    rng = np.random.default_rng(1)
    rng.integers(0, 256, (nlist, cap, m // 2), np.uint8)
    rng.integers(0, 256, (g, m, 16), np.uint8)
    sizes = rng.integers(0, cap + 1, nlist).astype(np.int32)
    probes = rng.integers(0, nlist, g).astype(np.int32)
    probes[rng.random(g) < 0.05] = -1
    bits = rng.integers(0, 256, (nlist, w), np.uint8)
    c = rl.stream_counts(probes, sizes, cap, bits)
    return dict(g=g, m=m, kc=40, n_tiles=4, live_rows=c["live_rows"],
                lists=c["lists"], filter_bytes=w, group_rows=c["group_rows"])


def _k3_shape():
    """K3's as grouped_phases draws them (seed 0 + 4), G = 128 x 32."""
    cap, nlist, g, m = 4096, 1024, 4096, 16
    rng = np.random.default_rng(4)
    rng.integers(0, 256, (nlist, cap, m // 2), np.uint8)
    rng.integers(0, 256, (g, m, 16), np.uint8)
    probes = rng.integers(0, nlist, g).astype(np.int32)
    probes[rng.random(g) < 0.05] = -1
    c = rl.stream_counts(probes, np.full(nlist, cap), cap)
    return dict(g=g, m=m, cap=cap, lists=c["lists"], groups=c["groups"])


def _k8(kv, g, m, hd, live):
    return dict(b=8, kv=kv, g=g, m=m, head_dim=hd, live=live)


# (kernel, its shape on chip_smoke.py's path, PERF.md's bound ms, by).
# K4's scanned rows depend on which tiles the kernel pruned: its counts
# are chip_smoke.py's "cost: K4" line (NVIDIA H100 80GB HBM3, 700 W).
BOUND_COLUMN = [
    ("fastscan_stream_topk", _k1_shape, "0.002037", "bytes"),
    ("rerank_stream_topk",
     lambda: dict(q=128, d=128, rp=64, k=10, valid=128 * 40 - 5),
     "0.000824", "bytes"),
    ("fastscan_stream_grouped", _k3_shape, "0.030171", "bytes"),
    ("fastscan_stream_topk_prune",
     lambda: dict(g=4096, m=16, kc=40, tile=1024, n_tiles=4,
                  **K4_COUNTS), "0.004161", "bytes"),
    ("fastscan_select_grouped", lambda: dict(g=4096, n=4096, m=16),
     "0.060410", "bytes"),
    ("fastscan_onehot_mma_grouped", lambda: dict(g=4096, n=4096, m=16),
     "0.060410", "bytes"),
    ("fastscan_select_flat", lambda: dict(q=128, n=1_000_000, m=16),
     "0.155234", "bytes"),
    ("fastscan_onehot_mma_flat", lambda: dict(q=128, n=1_000_000, m=16),
     "0.155234", "bytes"),
    ("fastscan_blockmin", lambda: dict(q=128, n=1_000_448, m=16, block=1024),
     "0.002698", "bytes"),
    ("pq_decode_attention", lambda: _k8(8, 2, 64, 128, 2111), "0.002640",
     "bytes"),                                            # qwen3
    ("pq_decode_attention", lambda: _k8(32, 1, 40, 80, 2079), "0.006441",
     "bytes"),                                            # zamba2
    ("pq_decode_attention", lambda: _k8(2, 7, 32, 64, 2079), "0.000452",
     "operations"),                                       # internvl2
    ("pq_decode_attention", lambda: _k8(24, 1, 32, 64, 2079), "0.003865",
     "bytes"),                                            # musicgen
    ("pq_decode_attention", lambda: _k8(8, 6, 64, 128, 2063), "0.003078",
     "operations"),                                       # dbrx
    ("pq_decode_attention", lambda: _k8(8, 5, 64, 128, 2063), "0.002655",
     "bytes"),                                            # llama4
]
K4_COUNTS = dict(live_rows=881721, tiles=3508, group_rows=1941619)


@pytest.mark.parametrize("case", range(len(BOUND_COLUMN)))
def test_kernel_cost_gives_perfs_bound_column(case):
    name, shape, bound, by = BOUND_COLUMN[case]
    ms, got_by = rl.kernel_bound_ms(name, **shape())
    assert (f"{ms:.6f}", got_by) == (bound, by)


# ---------------------------------------------------------------------------
# full cells, the report, the launchers
# ---------------------------------------------------------------------------

KEYS = {"arch", "shape", "kind", "seq", "batch", "kv_override", "kv_pq",
        "params", "active_params", "status", "mesh", "trace_s", "flops",
        "op_bytes", "min_bytes", "static_bytes", "peak_live_bytes", "fits",
        "cards_by_memory", "roofline", "launches", "ops", "kernels"}


@pytest.mark.parametrize("arch,shape,kv", [
    ("qwen3-1.7b", "train_4k", "auto"),
    ("zamba2-2.7b", "decode_32k", "pq"),
    ("rwkv6-3b", "long_500k", "auto"),
    ("dbrx-132b", "prefill_32k", "auto"),
    ("qwen3-1.7b", "long_500k", "auto"),
])
def test_run_cell_on_full_cells(tmp_path, arch, shape, kv):
    r = dryrun.run_cell(arch, shape, kv_override=kv, out_dir=str(tmp_path),
                        verbose=False)
    suffix = "" if kv == "auto" else f"_{kv}"
    with open(tmp_path / f"{arch}_{shape}_h100x1{suffix}.json") as f:
        assert json.load(f) == json.loads(json.dumps(r))
    if arch == "qwen3-1.7b" and shape == "long_500k":
        assert r["status"] == "skipped"
        assert r["reason"].startswith("SKIP: long_500k needs sub-quadratic")
        return
    assert r["status"] == "ok" and set(r) == KEYS
    assert r["mesh"] == "h100x1" and r["roofline"]["chips"] == 1
    assert r["roofline"]["t_collective_s"] == 0.0
    assert r["min_bytes"] >= r["static_bytes"] / 2 > 0
    assert r["fits"] == (r["peak_live_bytes"] <= rl.HBM_BYTES)
    assert r["cards_by_memory"] == -(-r["peak_live_bytes"] // rl.HBM_BYTES)
    assert r["roofline"]["model_flops_total"] == rl.model_flops(
        configs.get_config(arch), r["kind"], r["batch"], r["seq"])
    if (arch, shape) == ("zamba2-2.7b", "decode_32k"):
        assert r["kv_pq"] and r["kernels"] == {"pq_decode_attention": 9}
        assert r["fits"]
    if (arch, shape) == ("qwen3-1.7b", "train_4k"):
        # 256 x 4,096 tokens, microbatch 1: far past one card
        assert not r["fits"] and r["roofline"]["bottleneck"] == "compute"


def test_report_renders_both_tables(tmp_path):
    for arch, shape in (("rwkv6-3b", "long_500k"), ("qwen3-1.7b", "long_500k"),
                        ("qwen3-1.7b", "decode_32k")):
        dryrun.run_cell(arch, shape, out_dir=str(tmp_path), verbose=False)
    cells = report.load_cells(str(tmp_path))
    roof = report.roofline_table(cells).splitlines()
    assert roof[0].startswith("| arch | shape | status | t_compute")
    assert "peak live (fits)" in roof[0] and len(roof) == 5
    assert "SKIP (full attn @500k)" in "\n".join(roof)
    assert all("| — |" in row for row in roof[2:])
    table = report.dryrun_table(cells).splitlines()
    assert len(table) == 5 and "h100x1" in table[2]
    assert "(fits)" in "\n".join(table) and "cards)" in "\n".join(table)


LAUNCH = """
import runpy, sys
module, sys.argv = sys.argv[1], [sys.argv[1]] + sys.argv[2:]
try:
    runpy.run_module(module, run_name="__main__")
finally:
    bad = [k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib')
           or k == 'repro' or k.startswith('repro.')]
    assert not bad, bad
"""


def _launch(module: str, *args: str):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, "-c", LAUNCH, module, *args],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=ROOT)


def test_dryrun_cli_refuses_a_pod_mesh(tmp_path):
    """``--mesh pod`` no longer refuses: ``both`` sizes the cell per
    device on the (16, 16) and (2, 16, 16) meshes, loading no jax
    (``test_torch_sharding.py`` holds the bytes); a mesh the dry-run does
    not know is refused."""
    out = _launch("repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
                  "--shape", "decode_32k", "--mesh", "both", "--out",
                  str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all requested cells passed" in out.stdout
    assert sorted(os.listdir(tmp_path)) == [
        "qwen3-1.7b_decode_32k_multipod.json",
        "qwen3-1.7b_decode_32k_pod.json"]
    out = _launch("repro_torch.launch.dryrun", "--arch", "qwen3-1.7b",
                  "--mesh", "h100x4")
    assert out.returncode == 2 and "invalid choice" in out.stderr


def test_dryrun_cli_writes_a_cell_and_loads_no_jax(tmp_path):
    out = _launch("repro_torch.launch.dryrun", "--arch", "rwkv6-3b",
                  "--shape", "long_500k", "--out", str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    assert "all requested cells passed" in out.stdout
    assert os.listdir(tmp_path) == ["rwkv6-3b_long_500k_h100x1.json"]
    rep = subprocess.run([sys.executable, "-m", "repro_torch.launch.report",
                          str(tmp_path)], capture_output=True, text=True,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")),
                         cwd=ROOT, timeout=120)
    assert rep.returncode == 0 and "| rwkv6-3b | long_500k | ok |" in \
        rep.stdout


def test_the_new_modules_import_neither_jax_nor_the_reference():
    code = ("import sys\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.report\n"
            "import repro_torch.launch.roofline\n"
            "import repro_torch.launch.cost_analysis\n"
            "bad = [k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jaxlib') or k == 'repro' or k.startswith('repro.')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr[-2000:]
