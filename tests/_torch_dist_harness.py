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

With ``cells``, the four ranks hold the LM's prefill and decode cells
over two ``DeviceMesh``es of the same group, (2, 2) and (1, 4)
(``mesh_cells_body``; what is held is in its docstring).

With ``constrain``, the four ranks form a (2, 2) ``("data", "model")``
CPU mesh (``launch.mesh.make_host_mesh(model=2)``), and
``launch.sharding.constrain`` redistributes a replicated DTensor under
``use_mesh``: each rank's shard is the slice numpy gives for its mesh
coordinate, a dimension the divisibility fallback replicates stays whole,
a rules table that replicates everything gathers the shards back, and a
plain tensor under the mesh raises.

Prints OK and exits 0; any failure exits non-zero.
"""
import contextlib
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


# the eight attention-family archs the mesh cells serve, their PQ
# prefill's codebooks calibrated on this many sampled tokens
MESH_ARCHS = ("qwen3-1.7b", "qwen1.5-32b", "nemotron-4-15b", "starcoder2-15b",
              "dbrx-132b", "llama4-scout-17b-a16e", "internvl2-1b",
              "musicgen-medium")
# the archs whose cells run on both meshes; each other arch's on one, in
# turn (the mesh of its index's parity in MESH_ARCHS)
BOTH_MESHES = ("qwen3-1.7b", "dbrx-132b")
# a smoke variant whose 6 heads do not divide the (1, 4) mesh's model axis
# (the rules' head_dim and pq_m branch; qk-norm, RoPE and g = 3 over a
# sharded head_dim), and the MoE arch held under FSDP serving rules
HEAD_DIM_ARCH, HEAD_DIM_VARIANT = "qwen3-1.7b", {"n_heads": 6}
FSDP_ARCH = "dbrx-132b"
CELL_B, CELL_PROMPT, CELL_SMAX, CELL_STEPS = 4, 64, 1024, 4
CALIB_TOKENS = 32
TOL, LOGIT_TOL = 1e-5, 1e-4     # tests/test_torch_lm.py's
# a PQ cell's decode logits against the meshless step fed the mesh's
# codes (``_pq_steps``), over the row's largest |logit|: one bf16 unit,
# the precision K8 holds p at with bf16 codebooks, where a last-bit
# difference of a sharded sum can move a p across a rounding boundary
# (test_torch_mesh_cells.py reads it against planted faults)
PQ_LOGIT_RTOL = 2.0 ** -8
# a mesh rank's LUT scale and bias against the meshless step's, in f32
# units in the last place: the Mamba layers sum in another order over
# ranks, and zamba2-smoke's read up to 7.8 (scale) and 16.9 (bias)
LUT_ULPS = 32


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


class _Recorder:
    """Records the K/V rows the PQ encoder is given with the codes it
    returns, and the float and u8 LUTs K8 is given (``kvcache.encode_kv``,
    ``kvcache._quantize`` and, in K8's sub-space mode, a rank's slice of
    them, ``kvcache._quantize_over_ranks``, wrapped), while ``on``."""

    def __init__(self):
        from repro_torch.models import kvcache as kvc
        self.kvc, self.on = kvc, False
        self.encoded, self.tables, self.quantized = [], [], []
        real_encode, real_quantize = kvc.encode_kv, kvc._quantize
        real_over = kvc._quantize_over_ranks

        def over(lut):
            out = yield from real_over(lut)
            if self.on:
                self.tables.append((lut.clone(), out[0].clone()))
            return out

        def encode(x, cb):
            codes = real_encode(x, cb)
            if self.on:
                self.encoded.append((x.clone(), codes.clone()))
            return codes

        def quantize(lut):
            out = real_quantize(lut)
            if self.on:
                self.tables.append((lut.clone(), out[0].clone()))
                self.quantized.append(tuple(t.clone() for t in out))
            return out

        encode.__wrapped__ = real_encode
        kvc.encode_kv, kvc._quantize = encode, quantize
        kvc._quantize_over_ranks = over

    def take(self):
        out = (self.encoded, self.tables)
        self.encoded, self.tables, self.quantized = [], [], []
        return out

    def take_quantized(self) -> list:
        """The (u8 table, scale, bias) of each ``_quantize`` call since the
        last ``take``, taken before it."""
        return list(self.quantized)


# the recurrent smoke archs the mesh cells serve (zamba2 exact and with
# its PQ shared-attention cache, rwkv6 with none), each on both meshes
RECURRENT_ARCHS = (("zamba2-2.7b", False), ("zamba2-2.7b", True),
                   ("rwkv6-3b", False))


def hybrid_pq_cache(params, cfg, batch: int, smax: int) -> dict:
    """The hybrid's PQ cache (``init_cache``, zero codes and states) with
    codebooks calibrated on 2 x CALIB_TOKENS sampled tokens
    (``serve.calibrate_hybrid_codebooks``; ``serve_batch`` refuses a
    hybrid with kv_pq, as the reference's does)."""
    from repro_torch.launch import serve
    from repro_torch.models import model as ml
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, CALIB_TOKENS),
                                        np.int32))
    cache = ml.init_cache(cfg, batch, smax, device="cpu")
    cache.update(serve.calibrate_hybrid_codebooks(
        torch.Generator().manual_seed(0), params, cfg, toks))
    return cache


def _meshless(arch: str, pq: bool, rec: _Recorder, **over) -> dict:
    """The meshless port's prefill and CELL_STEPS greedy decode steps (the
    tokens each step feeds); a PQ cell with its calibrated codebooks in
    bf16, as the served configuration holds them. ``over``: fields of the
    smoke config replaced (a variant)."""
    from repro_torch import configs
    from repro_torch.launch import serve
    from repro_torch.models import model as ml
    cfg = configs.get_smoke_config(arch).replace(kv_pq=pq, **over)
    params = ml.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab,
                                          (CELL_B, CELL_PROMPT), np.int32))
    fe = None
    if cfg.frontend != "none" and not pq:
        fe = torch.as_tensor(rng.normal(size=(
            CELL_B, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    pqc = None
    if pq and cfg.block_type == "mamba2":
        pqc = hybrid_pq_cache(params, cfg, CELL_B, CELL_SMAX)
    elif pq:
        pqc = serve.calibrate_pq_cache(torch.Generator().manual_seed(0),
                                       params, cfg, CELL_B, CELL_SMAX,
                                       sample_tokens=CALIB_TOKENS)
        assert pqc.k_cb.dtype == torch.bfloat16, pqc.k_cb.dtype
    ref = {"cfg": cfg, "params": params, "tokens": tokens, "fe": fe,
           "pqc": pqc}
    rec.on = True
    try:
        logits, cache = ml.prefill(params, tokens, cfg, max_seq=CELL_SMAX,
                                   frontend_embeds=fe,
                                   pq_cache=_fresh(pqc))
        prompt_encoded = rec.take()[0]
    finally:
        rec.on = False
    prefill_cache = None
    if isinstance(cache, dict):     # the recurrent states, before decode
        prefill_cache = {k: v.clone() for k, v in cache.items()}
    prompt = None if not pq else (
        pq_view(cache).k_codes[:, :, :CELL_PROMPT].clone(),
        pq_view(cache).v_codes[:, :, :CELL_PROMPT].clone())
    feed, out, tok = [], [], torch.argmax(logits[:, :cfg.vocab], -1)
    for i in range(CELL_STEPS):
        pos = torch.full((CELL_B,), CELL_PROMPT + i, dtype=torch.int32)
        feed.append((tok, pos))
        step, cache = ml.decode_step(params, cache, tok, pos, cfg)
        out.append(step)
        tok = torch.argmax(step[:, :cfg.vocab], -1)
    ref.update(prefill=logits, prompt=prompt, prompt_encoded=prompt_encoded,
               feed=feed, logits=out, cache=cache,
               prefill_cache=prefill_cache)
    return ref


def pq_view(cache):
    """A PQ cache as a ``PQKVCache`` (the hybrid's dict: its shared
    attention's codes and codebooks)."""
    from repro_torch.models import kvcache as kvc
    if not isinstance(cache, dict):
        return cache
    return kvc.PQKVCache(*(cache[f"attn_{n}"] for n in kvc.PQKVCache._fields))


def _fresh(pqc):
    if pqc is None:
        return None
    if isinstance(pqc, dict):
        return {k: v if k.endswith("_cb") else torch.zeros_like(v)
                for k, v in pqc.items()}
    return type(pqc)(torch.zeros_like(pqc.k_codes),
                     torch.zeros_like(pqc.v_codes), pqc.k_cb, pqc.v_cb)


@contextlib.contextmanager
def kernel_order():
    """The CPU's K8 (``pq_decode_kernel.pq_decode``) in the kernel's own
    split-and-combine order (``pq_decode_plain(split=256)``: what the
    one-rank K8 computes on the card, and what the ranks' split passes and
    combine compute in their plain versions) in place of the reference's
    chunked order, which rounds p at other maxima."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    chunked = pqk.pq_decode

    def split_order(*args, chunk, out_dtype):
        return pqk.pq_decode_plain(*args, chunk=chunk, out_dtype=out_dtype,
                                   split=pqk.SPLIT)

    pqk.pq_decode = split_order
    try:
        yield
    finally:
        pqk.pq_decode = chunked


@contextlib.contextmanager
def fed_scales(quantized: list, rows: slice, what: str):
    """``kvcache._quantize`` returning, call by call, its own u8 table and
    bias and, on the batch rows ``rows``, the scale of the given (table,
    scale, bias) (a mesh rank's, recorded by ``_Recorder``): a meshless
    step whose K8 dequantizes its integer sums as the mesh's did. Each
    recorded scale and bias is first held to the meshless one within
    LUT_ULPS units in the last place of the row's scale or of its largest
    |LUT entry|."""
    from repro_torch.models import kvcache as kvc
    real, calls = kvc._quantize, iter(quantized)

    def quantize(lut):
        table, scale, bias = real(lut)
        _, fed, fed_bias = next(calls)
        ulp = torch.finfo(torch.float32).eps
        top = lut[rows].abs().amax((-2, -1))
        for name, got, want, unit in (
                ("scale", fed, scale[rows], scale[rows]),
                ("bias", fed_bias, bias[rows], top)):
            off = float(((got - want).abs() / (unit * ulp)).max())
            assert off <= LUT_ULPS, (
                f"{what}: the mesh's LUT {name} {off:.1f} ulps from the "
                f"meshless one (limit {LUT_ULPS})")
        scale = scale.clone()
        scale[rows] = fed
        return table, scale, bias

    kvc._quantize = quantize
    try:
        yield
    finally:
        kvc._quantize = real


def pq_reading(got, want) -> float:
    """The largest |logit difference| over each row's largest |logit| of
    ``want`` (the reading PQ_LOGIT_RTOL holds)."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    row = want.abs().amax(-1, keepdim=True).clamp_min(1e-30)
    return float(((got - want).abs() / row).max())


def _lut_ties(got: list, want: list, rows: slice, what: str,
              subs: slice = slice(None)) -> None:
    """The u8 LUTs of this rank's batch rows (and sub-spaces ``subs``, K8's
    sub-space mode) against the meshless ones: where an entry differs,
    the float LUTs must agree (a rounding tie of the quantizer fed inputs
    equal within float tolerance, not a different input)."""
    assert len(got) == len(want), what
    for (lg, tg), (lw, tw) in zip(got, want):
        lw, tw = lw[rows][..., subs, :], tw[rows][..., subs, :]
        if not torch.equal(tg, tw):
            _close(lg, lw, TOL, f"{what}: the float LUT under a u8 tie")


def _encoder_tie(x, cb, got, want, what: str) -> None:
    """Codes ``got`` and ``want`` of one (hd,) K/V row under its (M, 16,
    dsub) codebook differ only at sub-spaces where the row sits at a tie
    of the two codes' centroids (squared distances within 1e-4)."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    cg, cw = pqk.unpack_codes(got), pqk.unpack_codes(want)
    xs = x.float().reshape(cb.shape[0], -1)
    for sub in (cg != cw).nonzero().flatten().tolist():
        d = ((xs[sub] - cb[sub].float()) ** 2).sum(-1)
        gap = float(d[cg[sub]] - d[cw[sub]])
        assert abs(gap) <= 1e-4 * (1 + float(d[cw[sub]])), (
            f"{what}: codes differ at sub-space {sub} with no tie (gap "
            f"{gap})")


def _prompt_codes(got, want, encoded, pqc, what: str) -> bool:
    """The prompt's gathered codes against the meshless prefill's, up to
    encoder ties; whether any differ."""
    differ = False
    for which, (g, w, cb) in enumerate(((got.k_codes, want[0], pqc.k_cb),
                                        (got.v_codes, want[1], pqc.v_cb))):
        g = g[:, :, :CELL_PROMPT]
        for layer, b, pos, kvh in (g != w).any(-1).nonzero().tolist():
            _encoder_tie(encoded[2 * layer + which][0][b, pos, kvh],
                         cb[layer, kvh], g[layer, b, pos, kvh],
                         w[layer, b, pos, kvh], f"{what}: prompt")
            differ = True
    return differ


def _sub_slices(subs: slice, dsub: int) -> tuple[slice, slice]:
    """The head_dim and code-byte slices of the sub-spaces ``subs``."""
    if subs.start is None:
        return subs, subs
    return (slice(subs.start * dsub, subs.stop * dsub),
            slice(subs.start // 2, subs.stop // 2))


def _near_codes(got: list, want: list, rows: slice, pqc, what: str,
                subs: slice = slice(None)) -> int:
    """A decode step's new K/V rows on this rank's batch rows (and
    sub-spaces ``subs``, K8's sub-space mode) against the meshless step's:
    the mesh's codes are its own rows' nearest centroids (``encode_kv``),
    and where a sub-space's code differs from the meshless one, the
    mesh's centroid lies within 2e of the nearest to the meshless row (e
    the two rows' distance on that sub-space, the triangle inequality;
    1e-4 of slack for the f32 distances). Layer 0's rows, fed the same
    token, agree within TOL. Returns the sub-spaces whose codes differ."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.models import kvcache as kvc
    assert len(got) == len(want), what
    differ = 0
    dims, nbytes = _sub_slices(subs, pqc.k_cb.shape[-1])
    for j, ((xg, cg), (xw, cw)) in enumerate(zip(got, want)):
        cb = (pqc.k_cb, pqc.v_cb)[j % 2][j // 2][:, subs]
        xw, cw = xw[rows][..., dims], cw[rows][..., nbytes]
        assert torch.equal(kvc.encode_kv.__wrapped__(xg, cb), cg), what
        if j < 2:
            _close(xg, xw, TOL, f"{what}: layer 0's new K/V rows")
        ug, uw = pqk.unpack_codes(cg), pqk.unpack_codes(cw)
        m = cb.shape[1]
        for b, kvh, sub in (ug != uw).nonzero().tolist():
            xs_g = xg[b, kvh].float().reshape(m, -1)[sub]
            xs_w = xw[b, kvh].float().reshape(m, -1)[sub]
            d = ((xs_w - cb[kvh, sub].float()) ** 2).sum(-1).sqrt()
            e = float((xs_g - xs_w).norm())
            gap = float(d[ug[b, kvh, sub]] - d[uw[b, kvh, sub]])
            assert gap <= 2 * e + 1e-4 * (1 + float(d[uw[b, kvh, sub]])), (
                f"{what}: layer {j // 2}'s code at sub-space {sub} is "
                f"{gap} farther than the nearest, more than 2 x {e}")
            differ += 1
    return differ


def _pq_steps(ref: dict, got, full, recorded: list, rows: slice,
              rec: _Recorder, what: str, subs: slice = slice(None)
              ) -> tuple[float, int]:
    """A PQ cell's decode steps, each against the meshless step fed the
    mesh's codes: the meshless ``decode_step`` from the mesh's gathered
    cache ``got`` (its positions past the step are dead, and the step
    writes its own) with the same token, its K8 in the kernel's own order
    (``kernel_order``). Each step's logits ``full[i]``
    within PQ_LOGIT_RTOL (``pq_reading``); layer 0's u8 LUTs up to
    quantizer ties (``_lut_ties``); every layer's new codes near the
    meshless ones (``_near_codes``) and written by the mesh at the step's
    position; nothing written past the steps. Returns the largest reading
    and the count of codes that differ."""
    from repro_torch.models import model as ml
    cfg, params, pqc = ref["cfg"], ref["params"], ref["pqc"]
    worst, differ = 0.0, 0

    for i, ((tok, pos), (encoded, tables)) in enumerate(zip(ref["feed"],
                                                            recorded)):
        step = f"{what} step {i}"
        base = got._replace(k_codes=got.k_codes.clone(),
                            v_codes=got.v_codes.clone())
        rec.on = True
        try:
            with kernel_order():
                logits, _ = ml.decode_step(params, base, tok, pos, cfg)
            w_encoded, w_tables = rec.take()
        finally:
            rec.on = False
        reading = pq_reading(full[i], logits)
        assert reading <= PQ_LOGIT_RTOL, (
            f"{step}: logits {reading} of the row's largest |logit| from the "
            f"meshless step fed the mesh's codes (limit {PQ_LOGIT_RTOL})")
        worst = max(worst, reading)
        _lut_ties(tables[:1], w_tables[:1], rows, f"{step}: layer 0", subs)
        differ += _near_codes(encoded, w_encoded, rows, pqc, step, subs)
        at = CELL_PROMPT + i
        nbytes = _sub_slices(subs, pqc.k_cb.shape[-1])[1]
        for j, (_, codes) in enumerate(encoded):
            cache = (got.k_codes, got.v_codes)[j % 2][j // 2]
            assert torch.equal(cache[rows, at][..., nbytes], codes), (
                f"{step}: layer {j // 2}'s codes not at position {at}")
    past = CELL_PROMPT + CELL_STEPS
    assert not got.k_codes[:, :, past:].any(), what
    assert not got.v_codes[:, :, past:].any(), what
    return worst, differ


def _placements_and_bytes(cell, cfg, mesh, rules, kind: str, what: str):
    """Every parameter and cache leaf at its axes' placements, and this
    rank's local bytes equal ``dryrun.per_device`` for the mesh."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as ml
    roles = {"param": (cell.params, ml.lm_axes(cfg))}
    if cell.cache is not None:
        roles["cache"] = (cell.cache, ml.cache_axes(cfg))
    desc = mesh_lib.Mesh(mesh.shape)
    want = dryrun.per_device(cfg, kind, CELL_B, CELL_SMAX, desc, rules)
    for role, (tree, axes) in roles.items():
        total = 0
        shardings = shd.tree_shardings(tree, axes, desc, rules)
        for path, t, sh in shd.sharded_leaves(tree, shardings):
            assert tuple(t.placements) == sh.placements(), (
                f"{what}: {role} {path} at {t.placements}, its axes give "
                f"{sh.placements()}")
            local = t.to_local()
            assert tuple(local.shape) == sh.shard_shape(t.shape), (what, path)
            total += local.numel() * local.element_size()
        assert total == want[f"{role}_bytes"], (what, role, total, want)


def _subspaces(cfg, mesh, rules) -> slice:
    """This rank's sub-spaces where ``rules`` shard a PQ cache on them
    ("pq_m"), else all."""
    from repro_torch.launch import sharding as shd
    axis = shd._resolve_axis(mesh, rules, "pq_m")
    n = shd._axis_size(mesh, axis)
    if not cfg.kv_pq or n == 1:
        return slice(None)
    r = mesh.device_mesh.get_local_rank(axis)
    m = cfg.resolved_kv_pq_m // n
    return slice(r * m, (r + 1) * m)


def _cell(ref: dict, mesh, rec: _Recorder, what: str, rules=None,
          logit_tol: float = LOGIT_TOL) -> str:
    """The prefill and decode cells over ``mesh`` (under ``rules``, default
    the reference's ``cell_rules``) against the meshless ``ref``: the
    prefill's logits within ``logit_tol``; an exact cell's decode logits
    within ``logit_tol`` and its cache within TOL; a PQ cell's prompt
    codes up to encoder ties and its decode steps by ``_pq_steps``;
    placements and bytes. Returns a note of a PQ cell's readings."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    cfg, params = ref["cfg"], ref["params"]
    rules = rules or dryrun.cell_rules(cfg, "prefill_32k", mesh)
    di = mesh.device_mesh.get_coordinate()[0]
    bl = CELL_B // mesh.shape["data"]
    rows = slice(di * bl, (di + 1) * bl)
    pq = cfg.kv_pq
    rec.on = True
    try:
        cell = dryrun.mesh_cell(cfg, "prefill", mesh, rules, params,
                                tokens=ref["tokens"], cache=_fresh(ref["pqc"]),
                                max_seq=CELL_SMAX,
                                frontend_embeds=ref["fe"])
        _placements_and_bytes(cell, cfg, mesh, rules, "prefill", what)
        logits, cache = cell.step()
        rec.take()
        _close(logits.full_tensor(), ref["prefill"], logit_tol,
               f"{what}: prefill")
        prompt_tie = pq and _prompt_codes(
            shd.gather_tree(cache), ref["prompt"], ref["prompt_encoded"],
            ref["pqc"], what)
        dc = dryrun.mesh_cell(cfg, "decode", mesh, rules, params,
                              tokens=ref["feed"][0][0], cache=cache,
                              position=ref["feed"][0][1])
        # the steps' logits are gathered once, after the steps (a
        # collective costs milliseconds on gloo)
        outs, recorded = [], []
        for tok, pos in ref["feed"]:
            logits, _ = dc.step(tok, pos)
            outs.append(logits)
            recorded.append(rec.take())
    finally:
        rec.on = False
    full = torch.stack(outs).full_tensor()
    assert torch.isfinite(full).all(), what
    _placements_and_bytes(dc, cfg, mesh, rules, "decode", what)
    got = shd.gather_tree(dc.cache)
    if not pq:
        for i in range(CELL_STEPS):
            _close(full[i], ref["logits"][i], logit_tol,
                   f"{what}: decode step {i}")
        _close(got.k, ref["cache"].k, TOL, f"{what}: k cache")
        _close(got.v, ref["cache"].v, TOL, f"{what}: v cache")
        return ""
    assert torch.equal(got.k_cb, ref["pqc"].k_cb) and \
        torch.equal(got.v_cb, ref["pqc"].v_cb), what
    worst, differ = _pq_steps(ref, got, full, recorded, rows, rec, what,
                              _subspaces(cfg, mesh, rules))
    return (f"{what}: logits {worst:.3e} of the row's largest |logit| from "
            f"the meshless steps fed the mesh's codes; {differ} new codes "
            f"differ on rank {dist.get_rank()}"
            + ("; an encoder tie in the prompt" if prompt_tie else ""))


def _recurrent_cell(ref: dict, mesh, rec: _Recorder, what: str) -> str:
    """A recurrent arch's prefill and decode cells over ``mesh`` against
    the meshless ``ref``: the prefill's logits and its cache (the states;
    the hybrid's exact K/V) within LOGIT_TOL (tests/test_torch_recurrent.py
    holds the recurrent caches there), a PQ hybrid's prompt codes up to
    encoder ties; each exact decode step's logits and the cache after
    them within LOGIT_TOL; a PQ hybrid's
    each decode step against the meshless step from the mesh's cache as
    it was before the step (gathered: the states change each step) and fed
    the mesh's LUT scales on this rank's rows (``fed_scales``, which holds
    each scale and bias within LUT_ULPS first), its logits there within
    PQ_LOGIT_RTOL, every group's u8 LUTs up to quantizer ties, its new
    codes near the meshless ones (``_near_codes``); placements and bytes.
    The scales are fed because the hybrid's later layers amplify what one
    bf16 unit of K8's p moves: a scale some ulps off (the Mamba layers sum
    in another order over ranks) flips a p now and then. Unfed, one step
    on (1, 4) read 4.1e-3 of the row's largest |logit| where the others
    read ~1e-6; with the scale alone fed, every step reads ~5e-7. Returns
    a note of a PQ cell's readings."""
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as ml
    cfg, params = ref["cfg"], ref["params"]
    rules = dryrun.cell_rules(cfg, "prefill_32k", mesh)
    di = mesh.device_mesh.get_coordinate()[0]
    bl = CELL_B // mesh.shape["data"]
    rows = slice(di * bl, (di + 1) * bl)
    pq = cfg.kv_pq
    cell = dryrun.mesh_cell(cfg, "prefill", mesh, rules, params,
                            tokens=ref["tokens"], cache=_fresh(ref["pqc"]),
                            max_seq=CELL_SMAX)
    if pq:
        _placements_and_bytes(cell, cfg, mesh, rules, "prefill", what)
    rec.on = True
    try:
        logits, cache = cell.step()
        rec.take()
    finally:
        rec.on = False
    _close(logits.full_tensor(), ref["prefill"], LOGIT_TOL,
           f"{what}: prefill")
    got = shd.gather_tree(cache)
    for name, want in ref["prefill_cache"].items():
        if not name.startswith("attn_") or name in ("attn_k", "attn_v"):
            _close(got[name], want, LOGIT_TOL, f"{what}: prefill {name}")
    prompt_tie = pq and _prompt_codes(pq_view(got), ref["prompt"],
                                      ref["prompt_encoded"],
                                      pq_view(ref["pqc"]), what)
    dc = dryrun.mesh_cell(cfg, "decode", mesh, rules, params,
                          tokens=ref["feed"][0][0], cache=cache,
                          position=ref["feed"][0][1])
    outs, worst, differ = [], 0.0, 0
    for i, (tok, pos) in enumerate(ref["feed"]):
        base = shd.gather_tree(dc.cache) if pq else None
        rec.on = True
        try:
            logits, _ = dc.step(tok, pos)
            fed = rec.take_quantized()
            encoded, tables = rec.take()
        finally:
            rec.on = False
        outs.append(logits)
        if not pq:
            continue
        step = f"{what} step {i}"
        rec.on = True
        try:
            with kernel_order(), fed_scales(fed, rows, step):
                want, _ = ml.decode_step(params, base, tok, pos, cfg)
            w_encoded, w_tables = rec.take()
        finally:
            rec.on = False
        reading = pq_reading(logits.full_tensor()[rows], want[rows])
        assert reading <= PQ_LOGIT_RTOL, (
            f"{step}: logits {reading} of the row's largest |logit| from the "
            f"meshless step fed the mesh's cache and quantized LUTs (limit "
            f"{PQ_LOGIT_RTOL})")
        worst = max(worst, reading)
        _lut_ties(tables, w_tables, rows, f"{step}: every group")
        differ += _near_codes(encoded, w_encoded, rows, pq_view(ref["pqc"]),
                              step)
    full = torch.stack(outs).full_tensor()
    assert torch.isfinite(full).all(), what
    _placements_and_bytes(dc, cfg, mesh, rules, "decode", what)
    if pq:
        return (f"{what}: logits {worst:.3e} of the row's largest |logit| "
                f"from the meshless steps fed the mesh's cache and scales; "
                f"{differ} new codes differ on rank {dist.get_rank()}"
                + ("; an encoder tie in the prompt" if prompt_tie else ""))
    for i in range(CELL_STEPS):
        _close(full[i], ref["logits"][i], LOGIT_TOL,
               f"{what}: decode step {i}")
    for name, t in shd.gather_tree(dc.cache).items():
        _close(t, ref["cache"][name], LOGIT_TOL, f"{what}: {name} cache")
    return ""


def _moe_check(arch: str, mesh, what: str) -> None:
    """``moe_ffn`` of one layer under ``mesh`` against the meshless call on
    the same (B, S, D) input: the route's maps bit for bit on each rank's
    groups, the output within TOL; ``_dispatch`` makes no collective and
    ``_combine`` one all-reduce over "model" (``CommDebugMode``)."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import sharding as shd
    from repro_torch.models import model as ml
    from repro_torch.models import moe
    cfg = configs.get_smoke_config(arch)
    params = ml.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                        device="cpu")
    p = params.stack.blocks[0].moe
    x = torch.as_tensor(np.random.default_rng(3).normal(
        size=(CELL_B, 16, cfg.d_model)).astype(np.float32))
    maps = []
    real_route, real_dispatch, real_combine = (moe.route, moe._dispatch,
                                               moe._combine)
    comms = {}

    def route(g, c):
        r = real_route(g, c)
        maps.append(r)
        return r

    def counted(name, fn):
        def run(*a):
            with CommDebugMode() as cm:
                out = fn(*a)
            comms[name] = {str(k): v for k, v in cm.get_comm_counts().items()
                           if v}
            return out
        return run

    moe.route = route
    try:
        want, _ = moe.moe_ffn(p, x, cfg)
        want_maps = maps.pop()
        rules = dryrun.cell_rules(cfg, "decode_32k", mesh)
        with torch.inference_mode():
            pp = shd.shard_tree(params, ml.lm_axes(cfg), mesh, rules)
            xp = shd.shard_tree({"x": x}, {"x": ("batch", "seq", "embed")},
                                mesh, rules)["x"]
        moe._dispatch = counted("dispatch", real_dispatch)
        moe._combine = counted("combine", real_combine)
        with torch.inference_mode(), shd.use_mesh(mesh, rules):
            got, _ = moe.moe_ffn(pp.stack.blocks[0].moe, xp, cfg)
    finally:
        moe.route, moe._dispatch, moe._combine = (real_route, real_dispatch,
                                                  real_combine)
    local = maps.pop()
    gl = local.idx_k.shape[0]
    di = mesh.device_mesh.get_coordinate()[0]
    for name in local._fields:
        if name in ("aux", "gate_k"):
            continue
        assert torch.equal(getattr(local, name),
                           getattr(want_maps, name)[di * gl:(di + 1) * gl]), \
            f"{what}: the map {name} differs"
    _close(got.full_tensor(), want, TOL, f"{what}: moe_ffn")
    assert comms["dispatch"] == {}, (what, comms)
    assert comms["combine"] == {"c10d_functional.all_reduce": 1}, \
        (what, comms)


def _k8_sharded_plain(mesh, what: str) -> None:
    """K8's sharded mode in its plain versions over the mesh's "model"
    ranks (each rank's split pass at its offset, the partials all-gathered
    in rank order, the combine) equals ``pq_decode_plain(split=256)`` on
    the whole table and codes bit for bit."""
    from repro_torch.kernels import pq_decode_kernel as pqk
    from repro_torch.launch import sharding as shd
    g = torch.Generator().manual_seed(5)
    b, smax, kv, gq, m, dsub = 2, CELL_SMAX, 2, 2, 8, 2
    table = torch.randint(0, 256, (b, kv, gq, m, 16), generator=g,
                          dtype=torch.uint8)
    scale = torch.rand((b, kv, gq), generator=g) * 0.01 + 1e-3
    bias = torch.randn((b, kv, gq), generator=g)
    codes = [torch.randint(0, 256, (b, smax, kv, m // 2), generator=g,
                           dtype=torch.uint8) for _ in range(2)]
    cb = torch.randn((kv, m, 16, dsub), generator=g).to(torch.bfloat16)
    position = torch.tensor([smax // 3, smax - 1], dtype=torch.int32)
    want = pqk.pq_decode_plain(table, scale, bias, *codes, cb, position,
                               chunk=smax, out_dtype=torch.float32,
                               split=pqk.SPLIT)
    dm = mesh.device_mesh
    r, n = dm.get_local_rank("model"), dm.size(1)
    sl = smax // n
    work = pqk.pq_decode_split(table, scale, bias,
                               *(c[:, r * sl:(r + 1) * sl].contiguous()
                                 for c in codes), cb, position,
                               pos_offset=r * sl)
    got = pqk.pq_decode_combine(shd.all_gather(work, 3, dm, 1),
                                out_dtype=torch.float32)
    assert torch.equal(got, want), what


def mesh_cells_body() -> None:
    """The LM's prefill and decode cells (``launch.dryrun.mesh_cell``) of
    the eight attention-family smoke archs, exact and PQ (bf16 codebooks,
    as served), over a (2, 2) and a (1, 4) CPU mesh of the same four
    ranks (qwen3 and dbrx on both, the other archs on one each, in turn),
    at B 4, a 64-token prompt, Smax 1,024 (256 local positions at "model"
    4) and 4 greedy decode steps, against the meshless port run on each
    rank from the same seeds (the frontend archs' exact prefill with
    frontend embeddings):

    - the prefill's logits within LOGIT_TOL; an exact cell's decode
      logits within LOGIT_TOL and its cache within TOL;
    - a PQ cell's prompt codes equal the meshless ones up to encoder
      ties, and each decode step is held against the meshless step fed
      the mesh's codes (``_pq_steps``): its logits within PQ_LOGIT_RTOL,
      layer 0's u8 LUTs up to quantizer ties, every new code near the
      meshless one and written at the step's position;
    - every parameter and cache leaf keeps its rules' placements, and
      each rank's bytes equal ``dryrun.per_device``;
    - MoE (dbrx, llama4): the maps bit for bit, ``moe_ffn`` within TOL,
      ``_dispatch`` no collective, ``_combine`` one all-reduce;
    - K8's plain sharded mode equals ``pq_decode_plain(split=256)`` bit
      for bit;
    - zamba2-smoke, exact and PQ (its shared attention's K8 over a cache
      sharded on "kv_seq"), and rwkv6-smoke on both meshes, held by
      ``_recurrent_cell``;
    - a training cell raises;
    - a qwen3-smoke variant of 6 heads on (1, 4) (HEAD_DIM_VARIANT: the
      rules shard head_dim, and a PQ cache's sub-spaces, K8's sub-space
      mode), exact and PQ, held as above (a PQ cell's LUTs and codes on
      this rank's sub-spaces);
    - dbrx-smoke on (2, 2) under rules that keep "embed" on "data" (the
      pod's FSDP serving), exact and PQ, held as above.

    Rank 0 prints each PQ cell's largest logit reading."""
    from repro_torch import configs
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib
    meshes = [mesh_lib.make_host_mesh(model=m, device="cpu") for m in (2, 4)]
    rec = _Recorder()
    notes = []
    for k, arch in enumerate(MESH_ARCHS):
        on = meshes if arch in BOTH_MESHES else [meshes[k % 2]]
        for pq in (False, True):
            ref = _meshless(arch, pq, rec)
            for mesh in on:
                what = (f"{arch} {'pq' if pq else 'exact'} "
                        f"{tuple(mesh.shape.values())}")
                note = _cell(ref, mesh, rec, what)
                if note:
                    notes.append(note)
        if configs.get_smoke_config(arch).n_experts:
            for mesh in on:
                _moe_check(arch, mesh, f"{arch} moe "
                           f"{tuple(mesh.shape.values())}")
    for mesh in meshes:
        _k8_sharded_plain(mesh, f"K8 {tuple(mesh.shape.values())}")
    for arch, pq in RECURRENT_ARCHS:
        ref = _meshless(arch, pq, rec)
        for mesh in meshes:
            note = _recurrent_cell(ref, mesh, rec, (
                f"{arch} {'pq' if pq else 'exact'} "
                f"{tuple(mesh.shape.values())}"))
            if note:
                notes.append(note)
    try:
        dryrun.mesh_cell(configs.get_smoke_config("qwen3-1.7b"), "train",
                         meshes[0], dict(), None,
                         tokens=torch.zeros((1, 1), dtype=torch.int32))
    except NotImplementedError as e:
        assert "ROADMAP" in str(e) and "item 6" in str(e), e
    else:
        raise AssertionError("mesh_cell took a training cell")
    # heads that do not divide the model axis: the rules shard head_dim
    # and, with a PQ cache, its sub-spaces (K8's sub-space mode)
    for pq in (False, True):
        ref = _meshless(HEAD_DIM_ARCH, pq, rec, **HEAD_DIM_VARIANT)
        rules = dryrun.cell_rules(ref["cfg"], "decode_32k", meshes[1])
        assert rules["head_dim"] == "model" and (
            not pq or (rules["pq_m"], rules["kv_seq"]) == ("model", None)), \
            rules
        note = _cell(ref, meshes[1], rec, f"{HEAD_DIM_ARCH} "
                     f"{ref['cfg'].n_heads} heads {'pq' if pq else 'exact'} "
                     f"{tuple(meshes[1].shape.values())}")
        if note:
            notes.append(note)
    # MoE under rules that keep "embed" on "data" (the pod's FSDP serving)
    for pq in (False, True):
        ref = _meshless(FSDP_ARCH, pq, rec)
        rules = {**dryrun.cell_rules(ref["cfg"], "decode_32k", meshes[0]),
                 "embed": "data"}
        note = _cell(ref, meshes[0], rec, f"{FSDP_ARCH} embed on data "
                     f"{'pq' if pq else 'exact'} "
                     f"{tuple(meshes[0].shape.values())}", rules=rules)
        if note:
            notes.append(note)
    if dist.get_rank() == 0:
        for note in notes:
            print(note)


def main() -> int:
    rank, world, port = (int(a) for a in sys.argv[1:4])
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    bodies = {"constrain": constrain_body, "cells": mesh_cells_body}
    if sys.argv[4:5] and sys.argv[4] in bodies:
        try:
            bodies[sys.argv[4]]()
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
