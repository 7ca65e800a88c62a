"""The LM's prefill and decode cells over a mesh of ranks
(``launch.dryrun.mesh_cell``: parameters, caches and batch as DTensors
placed by the reference's ``cell_rules``, expert-parallel MoE, K8 over a
cache sharded on ``kv_seq``).

- Four gloo ranks (``tests/_torch_dist_harness.py ... cells``), started
  once when this module starts and run while the tests in this process
  do; their test, last, waits for them: a (2, 2) and a (1, 4) CPU mesh
  over the same group, the eight attention-family smoke archs with the
  exact and the PQ cache, against the meshless port (what is held is in
  ``mesh_cells_body``'s docstring).
- One gloo rank in this process: every cell bit for bit the meshless
  port (bf16 codebooks), its prefill also against the reference's.
- No ranks: K8's sharded mode in its plain versions (the split pass over
  shards at their offsets, the partials concatenated, the combine)
  against ``pq_decode_plain(split=256)``; its meta branch; the placement
  helpers.
"""
import os
import pathlib
import socket
import subprocess
import sys
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro import configs as jconfigs
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.launch import cost_analysis as ca
from repro_torch.launch import dryrun as tdry
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import roofline as rl
from repro_torch.launch import serve as tserve
from repro_torch.launch import sharding as tshd
from repro_torch.models import model as tmodel

_HARNESS = pathlib.Path(__file__).with_name("_torch_dist_harness.py")
sys.path.insert(0, str(_HARNESS.parent))
import _torch_dist_harness as harness  # noqa: E402

ARCHS = harness.MESH_ARCHS
B, PROMPT, SMAX, STEPS = (harness.CELL_B, harness.CELL_PROMPT,
                          harness.CELL_SMAX, harness.CELL_STEPS)
LOGIT_TOL = harness.LOGIT_TOL


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _nested(arrays: dict) -> dict:
    """Path-keyed arrays (``interop.arrays_from_lm_params``) as the
    reference's nested parameter tree of jax arrays."""
    out: dict = {}
    for key, a in arrays.items():
        node = out
        *parents, leaf = key.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = jnp.asarray(a)
    return out


# ---------------------------------------------------------------------------
# one gloo rank, in this process
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True)
def _one_thread():
    """These smoke-sized steps are a few thousand small ops each: one
    intra-op thread runs them faster than many competing for the cores
    (the four ranks run with OMP_NUM_THREADS=1 likewise)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture
def one_rank():
    """A one-rank gloo group and ``make_host_mesh``'s (1, 1) CPU mesh."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield tmesh.make_host_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def _inputs(cfg):
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (B, PROMPT),
                                          np.int32))
    fe = None
    if cfg.frontend != "none" and not cfg.kv_pq:
        fe = torch.as_tensor(rng.normal(size=(
            B, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    return tokens, fe


def _empty_codes(pqc):
    return harness._fresh(pqc)


@pytest.mark.parametrize("arch", ARCHS + ("zamba2-2.7b", "rwkv6-3b"))
def test_the_cells_at_one_rank_are_the_meshless_port_bit_for_bit(arch,
                                                                 one_rank):
    """Under the (1, 1) gloo mesh the prefill and 4 decode steps of
    ``mesh_cell``, exact (with the frontend stub's embeddings where the
    arch has one) and PQ (bf16 codebooks; none for rwkv6, which has no KV
    cache), equal the meshless port bit for bit: logits and every cache
    tensor (the recurrent states too); every leaf is a DTensor at its
    rules' placements."""
    mesh = one_rank
    pqs = (False,) if arch == "rwkv6-3b" else (False, True)
    for pq in pqs:
        cfg = tconfigs.get_smoke_config(arch).replace(kv_pq=pq)
        params = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(
            0), device="cpu")
        tokens, fe = _inputs(cfg)
        pqc = None
        if pq and cfg.block_type == "mamba2":
            pqc = harness.hybrid_pq_cache(params, cfg, B, SMAX)
        elif pq:
            pqc = tserve.calibrate_pq_cache(torch.Generator().manual_seed(0),
                                            params, cfg, B, SMAX,
                                            sample_tokens=32)
        want, wcache = tmodel.prefill(params, tokens, cfg, max_seq=SMAX,
                                      frontend_embeds=fe,
                                      pq_cache=_empty_codes(pqc))
        rules = tdry.cell_rules(cfg, "prefill_32k", mesh)
        cell = tdry.mesh_cell(cfg, "prefill", mesh, rules, params,
                              tokens=tokens, cache=_empty_codes(pqc),
                              max_seq=SMAX, frontend_embeds=fe)
        got, cache = cell.step()
        assert torch.equal(got.full_tensor(), want), (arch, pq)
        tok = torch.argmax(want[:, :cfg.vocab], -1)
        pos = torch.full((B,), PROMPT, dtype=torch.int32)
        dc = tdry.mesh_cell(cfg, "decode", mesh, rules, params, tokens=tok,
                            cache=cache, position=pos)
        for i in range(STEPS):
            pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
            want, wcache = tmodel.decode_step(params, wcache, tok, pos, cfg)
            got, _ = dc.step(tok, pos)
            assert torch.equal(got.full_tensor(), want), (arch, pq, i)
            tok = torch.argmax(want[:, :cfg.vocab], -1)
        axes = tdry.cache_entries(tmodel.cache_axes(cfg))
        got = tdry.cache_entries(dc.cache)
        assert set(got) == set(tdry.cache_entries(wcache))
        for name, w in tdry.cache_entries(wcache).items():
            t = got[name]
            assert torch.equal(t.full_tensor(), w), (arch, pq, name)
            assert tuple(t.placements) == tshd.named_sharding(
                t.shape, axes[name], mesh, rules).placements()
        for name, p in dc.params.named_parameters():
            assert tshd.is_placed(p), name


def test_a_one_rank_cell_is_the_references_prefill(one_rank):
    """qwen3-smoke's prefill cell under the (1, 1) mesh, from the
    reference's parameters, against the reference's prefill at
    LOGIT_TOL (the cache at 1e-5)."""
    arch = "qwen3-1.7b"
    jcfg, cfg = (jconfigs.get_smoke_config(arch),
                 tconfigs.get_smoke_config(arch))
    params = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    jparams = _nested(interop.arrays_from_lm_params(params))
    tokens, _ = _inputs(cfg)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(tokens.numpy()), jcfg,
                            max_seq=2 * PROMPT)
    rules = tdry.cell_rules(cfg, "prefill_32k", one_rank)
    got, cache = tdry.mesh_cell(cfg, "prefill", one_rank, rules, params,
                                tokens=tokens, max_seq=2 * PROMPT).step()
    harness._close(got.full_tensor(), np.asarray(jl), LOGIT_TOL, "logits")
    harness._close(cache.k.full_tensor(), np.asarray(jc.k), 1e-5, "k")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-15b",
                                  "dbrx-132b", "musicgen-medium"])
def test_the_pq_logit_limit_sees_f32_codebooks_and_a_position_off_by_one(
        arch):
    """The limit the four-rank run holds a PQ cell's decode logits to
    (``PQ_LOGIT_RTOL``, one bf16 unit of the row's largest |logit|, against
    the meshless step in K8's split order fed the same codes) reads two
    planted faults of that step over the cell's 4 decode steps: the
    codebooks in f32 in place of bf16 (p no longer rounded) above it in
    some step, the step fed its position less one above it in every
    step. Four archs: dense GQA (qwen3, starcoder2), MoE (dbrx) and MHA
    (musicgen). The readings are printed."""
    cfg = tconfigs.get_smoke_config(arch).replace(kv_pq=True)
    params = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    tokens, _ = _inputs(cfg)
    pqc = tserve.calibrate_pq_cache(torch.Generator().manual_seed(0), params,
                                    cfg, B, SMAX,
                                    sample_tokens=harness.CALIB_TOKENS)
    assert pqc.k_cb.dtype == torch.bfloat16
    logits, cache = tmodel.prefill(params, tokens, cfg, max_seq=SMAX,
                                   pq_cache=_empty_codes(pqc))
    f32 = cache._replace(k_cb=cache.k_cb.float(), v_cb=cache.v_cb.float())
    tok = torch.argmax(logits[:, :cfg.vocab], -1)
    readings = {"f32": [], "off": []}
    with harness.kernel_order():
        for i in range(STEPS):
            pos = torch.full((B,), PROMPT + i, dtype=torch.int32)

            def step(c, p=pos):
                return tmodel.decode_step(params, c._replace(
                    k_codes=c.k_codes.clone(), v_codes=c.v_codes.clone()),
                    tok, p, cfg)[0]

            want = step(cache)
            readings["f32"].append(harness.pq_reading(step(f32), want))
            readings["off"].append(harness.pq_reading(step(cache, pos - 1),
                                                      want))
            _, cache = tmodel.decode_step(params, cache, tok, pos, cfg)
            f32 = cache._replace(k_cb=f32.k_cb, v_cb=f32.v_cb)
            tok = torch.argmax(want[:, :cfg.vocab], -1)
    print(f"{arch}: limit {harness.PQ_LOGIT_RTOL:.3e}; f32 codebooks "
          f"{[f'{r:.3e}' for r in readings['f32']]}; position - 1 "
          f"{[f'{r:.3e}' for r in readings['off']]}")
    assert max(readings["f32"]) > harness.PQ_LOGIT_RTOL, readings
    assert min(readings["off"]) > harness.PQ_LOGIT_RTOL, readings


def test_shard_tree_copies_and_gather_tree_restores(one_rank):
    """``shard_tree`` leaves the given module as it was and returns a copy
    of DTensor parameters at their placements; ``gather_tree`` gives the
    tensors back; a leaf placed otherwise than its axes say is refused;
    ``placed_zeros`` allocates the local shard; ``shard_offset`` takes a
    mesh dimension of one rank for unsharded."""
    cfg = tconfigs.get_smoke_config("dbrx-132b")
    params = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rules = tdry.cell_rules(cfg, "decode_32k", one_rank)
    placed = tshd.shard_tree(params, tmodel.lm_axes(cfg), one_rank, rules)
    assert not any(tshd.is_placed(p) for p in params.parameters())
    back = tshd.gather_tree(placed)
    for name, p in params.named_parameters():
        assert torch.equal(back[name], p), name
    assert type(placed.stack.blocks) is type(params.stack.blocks)
    cache = tmodel.init_cache(cfg, 2, 8, device="cpu")
    pc = tshd.shard_tree(cache, tmodel.cache_axes(cfg), one_rank, rules)
    assert tshd.shard_tree(pc, tmodel.cache_axes(cfg), one_rank, rules) \
        .k is pc.k
    with pytest.raises(ValueError, match="where its axes"):
        tshd.shard_tree(pc, tmodel.cache_axes(cfg)._replace(
            k=(None,) * 5), one_rank, rules)
    assert tshd.shard_offset(pc.k, 2) == (0, None)
    with tshd.use_mesh(one_rank, rules):
        z = tshd.placed_zeros((2, 3, 8), ("batch", "kv_seq", None),
                              torch.float32, "cpu")
    assert tuple(z.to_local().shape) == (2, 3, 8) and not z.any()


def test_mesh_cell_refuses_what_waits_for_later_slices(one_rank):
    """A training cell raises, naming the roadmap's item 6; the recurrent
    archs' cells, which waited for item 5, run (zamba2's exact prefill,
    rwkv6's decode from a zero cache: finite logits, DTensors at the
    rules' placements); a decode cell without a cache or positions is
    refused."""
    cfg = tconfigs.get_smoke_config("qwen3-1.7b")
    tokens = torch.zeros((1, 4), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 6"):
        tdry.mesh_cell(cfg, "train", one_rank, tshd.DEFAULT_RULES, None,
                       tokens=tokens)
    for arch, kind in (("zamba2-2.7b", "prefill"), ("rwkv6-3b", "decode")):
        c = tconfigs.get_smoke_config(arch).replace(kv_pq=False)
        params = tmodel.init_lm(c, generator=torch.Generator().manual_seed(0),
                                device="cpu")
        rules = tdry.cell_rules(c, f"{kind}_32k", one_rank)
        cache = (tmodel.init_cache(c, 1, 8, device="cpu")
                 if kind == "decode" else None)
        cell = tdry.mesh_cell(c, kind, one_rank, rules, params,
                              tokens=tokens if cache is None else tokens[:, 0],
                              cache=cache, max_seq=8,
                              position=torch.zeros((1,), dtype=torch.int32))
        logits, out = cell.step()
        assert tshd.is_placed(logits) and torch.isfinite(
            logits.full_tensor()).all(), arch
        assert all(tshd.is_placed(t) for t in out.values()), arch
    with pytest.raises(ValueError, match="cache"):
        tdry.mesh_cell(cfg, "decode", one_rank, tshd.DEFAULT_RULES, None,
                       tokens=tokens[:, 0])
    with pytest.raises(ValueError, match="DeviceMesh"):
        tdry.mesh_cell(cfg, "prefill", tmesh.Mesh({"data": 1, "model": 1}),
                       tshd.DEFAULT_RULES, None, tokens=tokens)


# ---------------------------------------------------------------------------
# K8's sharded mode, plain, without ranks
# ---------------------------------------------------------------------------

def _k8_inputs(smax: int, q8: bool, cb_dtype, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    b, kv, gq, m, dsub = 3, 2, 2, 8, 2
    if q8:
        table = torch.randint(0, 256, (b, kv, gq, m, 16), generator=g,
                              dtype=torch.uint8)
        scale = torch.rand((b, kv, gq), generator=g) * 0.01 + 1e-3
        bias = torch.randn((b, kv, gq), generator=g)
    else:
        table = torch.randn((b, kv, gq, m, 16), generator=g) * 0.3
        scale = bias = None
    codes = [torch.randint(0, 256, (b, smax, kv, m // 2), generator=g,
                           dtype=torch.uint8) for _ in range(2)]
    cb = torch.randn((kv, m, 16, dsub), generator=g).to(cb_dtype)
    # a row live in the first split only, one live to the middle (past
    # some shards' ranges: their offsets lie past its live range), one
    # whole
    position = torch.tensor([5, smax // 2 + 17, smax - 1], dtype=torch.int32)
    return table, scale, bias, codes, cb, position


def _over_shards(table, scale, bias, codes, cb, position, n: int,
                 out_dtype):
    smax = codes[0].shape[1]
    sl = smax // n
    works = [pqk.pq_decode_split(
        table, scale, bias, *(c[:, r * sl:(r + 1) * sl].contiguous()
                              for c in codes), cb, position,
        pos_offset=r * sl) for r in range(n)]
    return pqk.pq_decode_combine(torch.cat(works, dim=3),
                                 out_dtype=out_dtype)


@pytest.mark.parametrize("n", [1, 2, 4, 16])
@pytest.mark.parametrize("q8, cb_dtype", [(True, torch.bfloat16),
                                          (False, torch.float32)])
def test_k8_plain_sharded_mode_is_the_one_rank_split_order(n, q8, cb_dtype):
    """Smax 4,096 over n shards of a multiple of 256 positions (at 16, a
    shard wholly past two rows' live ranges and one shard dead for all
    but the last row): the shards' split passes at their offsets,
    concatenated, combined, equal ``pq_decode_plain(split=256)`` bit for
    bit, in bf16 (u8 LUT) and f32 (f32 LUT)."""
    table, scale, bias, codes, cb, position = _k8_inputs(4096, q8, cb_dtype)
    out = torch.bfloat16 if cb_dtype == torch.bfloat16 else torch.float32
    want = pqk.pq_decode_plain(table, scale, bias, *codes, cb, position,
                               chunk=4096, out_dtype=out, split=pqk.SPLIT)
    got = _over_shards(table, scale, bias, codes, cb, position, n, out)
    assert torch.equal(got, want)


def test_k8_plain_sharded_mode_at_ragged_shards_is_within_tolerance():
    """Smax 1,024 over 16 shards of 64 positions: the shards' splits are
    not the one-rank call's 256-position ones, so the result is not bit
    for bit but within K8's tolerances of ``pq_decode_plain(split=256)``:
    1e-5 with f32 codebooks, 2**-6 of each row's largest |value| with
    bf16."""
    for cb_dtype, tol in ((torch.float32, 1e-5), (torch.bfloat16, 2 ** -6)):
        table, scale, bias, codes, cb, position = _k8_inputs(1024, True,
                                                             cb_dtype)
        want = pqk.pq_decode_plain(table, scale, bias, *codes, cb, position,
                                   chunk=1024, out_dtype=torch.float32,
                                   split=pqk.SPLIT)
        got = _over_shards(table, scale, bias, codes, cb, position, 16,
                           torch.float32)
        assert not torch.equal(got, want)
        bound = tol * want.abs().amax(-1, keepdim=True).clamp_min(1.0)
        assert ((got - want).abs() <= bound).all(), cb_dtype


def test_k8_split_and_combine_check_their_arguments():
    table, scale, bias, codes, cb, position = _k8_inputs(512, True,
                                                         torch.bfloat16)
    with pytest.raises(ValueError, match="position"):
        pqk.pq_decode_split(table, scale, bias, *codes, cb, position[:2])
    with pytest.raises(ValueError, match="work"):
        pqk.pq_decode_combine(torch.zeros((3, 2, 2, 4, 2)),
                              out_dtype=torch.float32)
    with pytest.raises(ValueError, match="work"):
        pqk.pq_decode_combine(torch.zeros((3, 2, 2, 4)),
                              out_dtype=torch.float32)


def test_k8_meta_records_one_launch_a_pass():
    """On meta, the split pass and the combine pass each record one
    launch of their own cost (``roofline.kernel_cost``) on the counter:
    the split pass with the counter's live positions past its offset, the
    combine with the live splits among those it is given; nothing else is
    counted."""
    meta = torch.device("meta")
    b, kv, g, m, hd, smax = 8, 8, 2, 64, 128, 1024
    table = torch.empty((b, kv, g, m, 16), dtype=torch.uint8, device=meta)
    scale = torch.empty((b, kv, g), device=meta)
    codes = torch.empty((b, smax, kv, m // 2), dtype=torch.uint8,
                        device=meta)
    cb = torch.empty((kv, m, 16, hd // m), dtype=torch.bfloat16, device=meta)
    pos = torch.empty((b,), dtype=torch.int32, device=meta)
    def both():
        return (pqk.pq_decode_split(table, scale, scale, codes, codes, cb, pos,
                                    pos_offset=512),
                pqk.pq_decode_combine(torch.empty((b, kv, g, 16, hd + 2),
                                                  device=meta),
                                      out_dtype=torch.bfloat16))

    before = pqk.launches
    (work, out), c = ca.count(both, live_positions=700)
    assert pqk.launches == before
    assert tuple(work.shape) == (b, kv, g, 4, hd + 2)
    assert tuple(out.shape) == (b, kv * g, hd) and out.dtype == torch.bfloat16
    assert c.kernels == {"pq_decode_split": 1, "pq_decode_combine": 1}
    # 188 local positions live a row: its first split live, three dead
    nbytes, ops, _ = rl.kernel_cost("pq_decode_split", b=b, kv=kv, g=g, m=m,
                                    head_dim=hd, live=188, nsplit=4)
    assert c.bytes_by_op["pq_decode_split"] == nbytes
    assert c.flops_by_op["pq_decode_split"] == ops
    heads = kv * g
    assert nbytes == (2 * b * 188 * kv * (m // 2) + b * heads * m * 16
                      + 2 * 4 * b * heads + kv * m * 16 * (hd // m) * 2
                      + 4 * b + b * heads * ((hd + 2) * 4 + 3 * 8))
    # 700 positions: 3 of the 16 splits live
    nbytes, ops, _ = rl.kernel_cost("pq_decode_combine", b=b, kv=kv, g=g,
                                    head_dim=hd, nsplit=16, live_splits=3)
    assert c.bytes_by_op["pq_decode_combine"] == nbytes
    assert nbytes == b * heads * (16 * 4 + 3 * (hd + 1) * 4 + hd * 2)


@pytest.mark.parametrize("live", [0, 1, 256, 700, [0, 700, 1024, 5]])
def test_k8_split_and_combine_costs_count_only_live_splits(live):
    """``roofline``'s costs of K8's two passes: a dead split writes its
    8-byte (m_j, l_j) alone and reads nothing; a row with no live
    position reads only its position; the combine reads a dead split's
    m_j alone. Across shards, the split passes' reads and work add up to
    the one-rank split pass's."""
    b, kv, g, m, hd, nsplit = 4, 2, 3, 16, 64, 4
    rows = [live] * b if isinstance(live, int) else live
    shape = dict(b=b, kv=kv, g=g, m=m, head_dim=hd, q8=True, cb_itemsize=2)
    nbytes, ops, _ = rl.kernel_cost("pq_decode_split", live=live,
                                    nsplit=nsplit, **shape)
    heads = kv * g
    live_splits = [-(-n // pqk.SPLIT) for n in rows]
    live_rows = sum(n > 0 for n in rows)
    reads = (2 * sum(rows) * kv * (m // 2) + live_rows * heads * (m * 16 + 8)
             + (kv * m * 16 * (hd // m) * 2 if live_rows else 0) + 4 * b)
    writes = heads * sum(s * (hd + 2) * 4 + (nsplit - s) * 8
                         for s in live_splits)
    assert nbytes == reads + writes
    assert ops == heads * sum(rows) * (m + hd) * 2
    if not any(rows):
        assert nbytes == 4 * b + b * heads * nsplit * 8
    cb, cops, _ = rl.kernel_cost("pq_decode_combine", b=b, kv=kv, g=g,
                                 head_dim=hd, nsplit=nsplit,
                                 live_splits=live_splits, out_itemsize=2)
    assert cb == heads * (b * nsplit * 4 + sum(live_splits) * (hd + 1) * 4
                          + b * hd * 2)
    assert cops == heads * sum(live_splits) * hd * 2
    # two shards of two splits each: their codes and work are the whole's
    halves = [[max(0, min(n - off, 2 * pqk.SPLIT)) for n in rows]
              for off in (0, 2 * pqk.SPLIT)]
    parts = [rl.kernel_cost("pq_decode_split", live=h, nsplit=2, **shape)
             for h in halves]
    assert sum(p[1] for p in parts) == ops


# ---------------------------------------------------------------------------
# four gloo ranks
# ---------------------------------------------------------------------------

_FOUR_RANKS = "test_the_cells_over_four_gloo_ranks_equal_the_meshless_port"


@pytest.fixture(scope="module", autouse=True)
def _four_ranks(request):
    """The four gloo ranks of ``_torch_dist_harness.py ... cells``,
    started when this module's first test starts (if the four-rank test
    was collected), so that they run while the tests in this process do;
    any rank still running when the module ends is killed. Each rank's
    stdout and stderr go to a file of its own."""
    if not any(item.name == _FOUR_RANKS and item.module is request.module
               for item in request.session.items):
        yield None
        return
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(4)]
    procs = [subprocess.Popen([sys.executable, str(_HARNESS), str(rank), "4",
                               str(port), "cells"], env=env, stdout=out,
                              stderr=err, text=True)
             for rank, (out, err) in enumerate(logs)]
    try:
        yield procs, logs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()


def test_the_cells_over_four_gloo_ranks_equal_the_meshless_port(_four_ranks):
    """``_torch_dist_harness.py ... cells`` on four ranks (started by
    ``_four_ranks``): every cell of the eight archs, exact and PQ, on
    (2, 2) or (1, 4) (qwen3 and dbrx on both) within the LM tolerances of
    the meshless port (a PQ cell's decode steps within PQ_LOGIT_RTOL of
    the meshless step fed the mesh's codes), placements and per-device
    bytes, the MoE bodies' maps and collectives, K8's plain sharded mode,
    the refusals. Rank 0 prints each PQ cell's largest logit reading."""
    procs, logs = _four_ranks
    outs = []
    for p, (out, err) in zip(procs, logs):
        p.wait(timeout=400)
        out.seek(0)
        err.seek(0)
        outs.append((out.read(), err.read()))
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0 and out.strip().endswith("OK"), (
            f"rank failed\nstdout:\n{out}\nstderr:\n{err[-4000:]}")
    print(outs[0][0])
