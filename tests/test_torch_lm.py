"""The port's LM serving path (``repro_torch.models``, ``configs``,
``launch.serve``) held against the JAX reference on the CPU.

Four smoke configs run: qwen3-smoke (GQA with g = 2, qk_norm),
qwen1.5-smoke (qkv_bias, MHA with g = 1, kv_pq), nemotron-smoke (the
squared-ReLU FFN) and starcoder2-smoke (the GELU FFN), in f32, with inputs made
by numpy and the reference's parameters carried across by ``interop``.
Tolerances: f32 layer stages at atol = rtol = 1e-5; the PQ decode
attention's plain version and the model's logits at 1e-4 (summation order,
the chunked online softmax); integer stages (ADC sums, packed codes,
decoded rows) bit for bit, ``encode_kv``'s argmin up to near-ties of the
reference's own distances (within 1e-5 relative, at most 1% of the
codes); greedy tokens equal, or a near-tie of the reference's top two
logits. With bf16 codebooks (as calibration makes them) the value product
rounds each chunk's sum to bf16 in both packages: those cases are held at
2e-3 of the output's scale (two bf16 roundings).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import fastscan as jfs
from repro.launch import serve as jserve
from repro.models import kvcache as jkvc
from repro.models import layers as jll
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.kernels import pq_decode_kernel as tpqk
from repro_torch.launch import serve as tserve
from repro_torch.models import kvcache as tkvc
from repro_torch.models import layers as tll
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttf

TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-3
ARCHS = ("qwen3-1.7b", "qwen1.5-32b", "nemotron-4-15b", "starcoder2-15b")
# what the port does not serve: nothing, since the MoE archs
# (tests/test_torch_moe.py) and the frontend stubs
# (tests/test_torch_frontend.py) joined the dense and recurrent families
UNPORTED = ()
B, PROMPT, GEN = 2, 64, 4


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


def _flat(tree, prefix=""):
    """A reference parameter tree as /-joined path keys -> numpy."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _cfgs(arch):
    return jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, port cfg, reference params, port model)."""
    jcfg, tcfg = _cfgs(request.param)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_arrays(_flat(jparams), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jparams, model


def _prompts(cfg, seed=0, b=B, s=PROMPT):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
            {f: getattr(want, f) for f in want.__dataclass_fields__}
        assert got.param_count() == want.param_count()
        assert got.padded_vocab == want.padded_vocab
        assert got.resolved_kv_pq_m == want.resolved_kv_pq_m
    assert tconfigs.ALIASES == jconfigs.ALIASES


def test_unported_archs_raise_naming_the_roadmap():
    # every arch of the reference is ported; an unknown name is a KeyError
    assert tuple(a for a in tconfigs.ARCHS if a not in tconfigs.PORTED) == \
        UNPORTED
    assert tconfigs.PORTED == tconfigs.ARCHS == jconfigs.ARCHS
    for arch in tconfigs.ARCHS:
        assert tconfigs.get_config(arch).name == jconfigs.get_config(arch).name
    for get in (tconfigs.get_config, tconfigs.get_smoke_config):
        with pytest.raises(KeyError, match="unknown arch"):
            get("gpt-5")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_and_rope_match_reference():
    rng = np.random.default_rng(1)
    x = rng.normal(0, 2, (2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(1, 0.1, 16).astype(np.float32)
    _close(tll.rmsnorm(_t(x), _t(w), 1e-5),
           jll.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-5), TOL)
    pos = rng.integers(0, 4096, (2, 5)).astype(np.int32)
    for theta in (10_000.0, 1_000_000.0):
        _close(tll.rope(_t(x), _t(pos), theta),
               jll.rope(jnp.asarray(x), jnp.asarray(pos), theta), TOL)


def test_qkv_project_matches_reference(pair):
    _, jcfg, tcfg, jparams, model = pair
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 7, tcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7))
    jp = jax.tree.map(lambda a: a[0], jparams["stack"]["blocks"])
    want = jll.qkv_project(jp["attn"], jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = tll.qkv_project(model.stack.blocks[0].attn, _t(x), tcfg, _t(pos))
    for g, w in zip(got, want):
        _close(g, w, TOL)


# (seq, q chunk, kv chunk, softcap): the chunked branch (several q and kv
# chunks, blocks past the frontier skipped), and the full branch by each
# of the reference's conditions (s % cq, s % ckv, s <= cq)
ATTN_CASES = [(64, 16, 32, 0.0), (64, 32, 16, 0.0), (64, 16, 16, 30.0),
              (40, 16, 16, 0.0), (48, 16, 32, 0.0), (32, 32, 32, 0.0)]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("arch", ARCHS)
def test_causal_attention_matches_reference(arch, case):
    s, cq, ckv, cap = case
    jcfg, tcfg = (c.replace(attn_q_chunk=cq, attn_kv_chunk=ckv,
                            attn_logit_softcap=cap) for c in _cfgs(arch))
    h, kv = tcfg.n_heads, tcfg.n_kv_heads
    hd = tcfg.resolved_head_dim
    rng = np.random.default_rng(3)
    q = rng.normal(0, 1, (2, s, h, hd)).astype(np.float32)
    k = rng.normal(0, 1, (2, s, kv, hd)).astype(np.float32)
    v = rng.normal(0, 1, (2, s, kv, hd)).astype(np.float32)
    want = jll.chunked_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), jcfg)
    got = tll.chunked_causal_attention(_t(q), _t(k), _t(v), tcfg)
    _close(got, want, TOL)
    _close(tll.full_causal_attention(_t(q), _t(k), _t(v), tcfg),
           jll.full_causal_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), jcfg), TOL)


@pytest.mark.parametrize("mlp_type", ["swiglu", "gelu", "relu2"])
def test_ffn_matches_reference(mlp_type):
    jcfg, tcfg = (c.replace(mlp_type=mlp_type)
                  for c in _cfgs("qwen3-1.7b"))
    specs = jll.ffn_specs(jcfg)
    jp = jll.init_params(jax.random.PRNGKey(4), specs)
    tp = tll.Params(tll.ffn_specs(tcfg), dtype=torch.float32,
                    device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(jp[name]))
    x = np.random.default_rng(5).normal(0, 1, (2, 3, tcfg.d_model)
                                        ).astype(np.float32)
    _close(tll.ffn(tp, _t(x), tcfg), jll.ffn(jp, jnp.asarray(x), jcfg), TOL)


def test_decode_attention_scores_matches_reference():
    jcfg, tcfg = _cfgs("qwen3-1.7b")
    rng = np.random.default_rng(6)
    b, skv, h, kv, hd = 3, 24, 4, 2, 16
    q = rng.normal(0, 1, (b, h, hd)).astype(np.float32)
    kc = rng.normal(0, 1, (b, skv, kv, hd)).astype(np.float32)
    vc = rng.normal(0, 1, (b, skv, kv, hd)).astype(np.float32)
    pos = np.array([0, 11, 23], np.int32)
    _close(tll.decode_attention_scores(_t(q), _t(kc), _t(vc), tcfg, _t(pos)),
           jll.decode_attention_scores(jnp.asarray(q), jnp.asarray(kc),
                                       jnp.asarray(vc), jcfg,
                                       jnp.asarray(pos)), TOL)


# ---------------------------------------------------------------------------
# PQ KV cache
# ---------------------------------------------------------------------------

def _pq_inputs(seed, b=2, smax=32, kv=2, g=2, m=8, dsub=2):
    rng = np.random.default_rng(seed)
    hd = m * dsub
    return dict(
        q=rng.normal(0, 1, (b, kv * g, hd)).astype(np.float32),
        k_codes=rng.integers(0, 256, (b, smax, kv, m // 2), dtype=np.uint8),
        v_codes=rng.integers(0, 256, (b, smax, kv, m // 2), dtype=np.uint8),
        k_cb=rng.normal(0, 1, (kv, m, 16, dsub)).astype(np.float32),
        v_cb=rng.normal(0, 1, (kv, m, 16, dsub)).astype(np.float32))


def test_encode_kv_matches_reference_up_to_near_ties():
    rng = np.random.default_rng(7)
    kv, m, dsub = 2, 8, 2
    cb = rng.normal(0, 1, (kv, m, 16, dsub)).astype(np.float32)
    x = rng.normal(0, 1, (64, kv, m * dsub)).astype(np.float32)
    want = np.asarray(jkvc.encode_kv(jnp.asarray(x), jnp.asarray(cb)))
    got = tkvc.encode_kv(_t(x), _t(cb)).numpy()
    # the reference's own distances: which codes are near-ties
    d = ((x.reshape(64, kv, m, 1, dsub) - cb[None]) ** 2).sum(-1)
    top2 = np.sort(d, axis=-1)[..., :2]
    tie = (top2[..., 1] - top2[..., 0]) <= 1e-5 * np.maximum(top2[..., 1], 1e-30)
    lo_ok = ((got & 15) == (want & 15)) | tie[..., 0::2]
    hi_ok = ((got >> 4) == (want >> 4)) | tie[..., 1::2]
    assert lo_ok.all() and hi_ok.all()
    assert np.mean(got != want) <= 0.01
    # a cache's (B, S, KV, hd) rows at once: the same codes row by row
    xs = x.reshape(4, 16, kv, m * dsub)
    np.testing.assert_array_equal(tkvc.encode_kv(_t(xs), _t(cb)).numpy(),
                                  got.reshape(4, 16, kv, m // 2))


@pytest.mark.parametrize("cb_dtype", ["float32", "bfloat16"])
def test_decode_kv_bit_for_bit(cb_dtype):
    inp = _pq_inputs(8)
    cb = jnp.asarray(inp["v_cb"]).astype(cb_dtype)
    want = np.asarray(jkvc.decode_kv(jnp.asarray(inp["v_codes"]), cb)
                      .astype(jnp.float32))
    got = tkvc.decode_kv(_t(inp["v_codes"]),
                         _t(inp["v_cb"]).to(getattr(torch, cb_dtype)))
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_adc_sums_bit_for_bit_from_the_reference_table():
    inp = _pq_inputs(9, smax=40, m=16)
    b, kv, g, hd = 2, 2, 2, 32
    qg = jnp.asarray(inp["q"]).reshape(b, kv, g, hd)
    lut = jkvc._build_ip_lut(qg, jnp.asarray(inp["k_cb"])) / np.sqrt(hd)
    tlut = tkvc._build_ip_lut(_t(inp["q"]).reshape(b, kv, g, hd),
                              _t(inp["k_cb"])) / np.sqrt(hd)
    _close(tlut, lut, TOL)
    qlut = jfs.quantize_lut(lut.reshape(-1, 16, 16))
    table = np.asarray(qlut.table_q8).reshape(b, kv, g, 16, 16)
    # the integer stage: exact, from the reference's own table
    codes = tpqk.unpack_codes(_t(inp["k_codes"])).numpy()   # (B, C, KV, M)
    want = np.zeros((b, kv, g, 40), np.int64)
    for mm in range(16):
        want += np.take_along_axis(
            table[:, :, :, mm, :].astype(np.int64),
            codes[:, :, :, mm].transpose(0, 2, 1)[:, :, None, :], axis=-1)
    got = tpqk.adc_sums(_t(table), _t(inp["k_codes"]))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # and the dequantized scores, fed that table, against the reference's
    for q8 in (True, False):
        _close(tkvc._adc_scores(tlut, _t(inp["k_codes"]), q8,
                                table_q8=_t(table) if q8 else None),
               jkvc._adc_scores(lut, jnp.asarray(inp["k_codes"]), q8), TOL)


def test_f32_lut_scores_add_in_the_kernels_order():
    # K8 adds an f32 LUT's entries one sub-space after another; the plain
    # version's scores follow that order, so the kernel's equal them bit
    # for bit (a reduction in another order differs where large terms
    # cancel)
    rng = np.random.default_rng(19)
    b, kv, g, m, c = 2, 2, 3, 64, 40
    table = (rng.normal(0, 30, (b, kv, g, m, 16))).astype(np.float32)
    packed = rng.integers(0, 256, (b, c, kv, m // 2), dtype=np.uint8)
    got = tpqk.adc_scores(_t(table), None, None, _t(packed)).numpy()
    codes = tpqk.unpack_codes(_t(packed)).numpy()          # (B, C, KV, M)
    want = np.zeros((b, kv, g, c), np.float32)
    for j in range(m):
        want += np.take_along_axis(
            table[:, :, :, j, :],
            codes[:, :, :, j].transpose(0, 2, 1)[:, :, None, :], axis=-1)
    np.testing.assert_array_equal(got, want)


# (positions, chunk, codebook dtype)
PQ_ATTN_CASES = [([0, 31], 8, "float32"), ([5, 17], 8, "float32"),
                 ([31, 31], 32, "float32"), ([-1, 9], 16, "float32"),
                 ([3, 30], 8, "bfloat16")]


@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("case", PQ_ATTN_CASES)
def test_pq_decode_attention_plain_matches_reference(case, q8):
    positions, chunk, cb_dtype = case
    inp = _pq_inputs(10)
    pos = np.asarray(positions, np.int32)
    jcb = {k: jnp.asarray(inp[k]).astype(cb_dtype) for k in ("k_cb", "v_cb")}
    want = jkvc.pq_decode_attention(
        jnp.asarray(inp["q"]), jnp.asarray(inp["k_codes"]),
        jnp.asarray(inp["v_codes"]), jcb["k_cb"], jcb["v_cb"],
        jnp.asarray(pos), chunk=chunk, quantize_q8=q8)
    tdt = getattr(torch, cb_dtype)
    got = tkvc.pq_decode_attention(
        _t(inp["q"]), _t(inp["k_codes"]), _t(inp["v_codes"]),
        _t(inp["k_cb"]).to(tdt), _t(inp["v_cb"]).to(tdt), _t(pos),
        chunk=chunk, quantize_q8=q8)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 16)
    if cb_dtype == "float32":
        _close(got, want, LOGIT_TOL)
    else:
        scale = float(np.abs(np.asarray(want)).max())
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= \
            BF16_TOL * scale


def test_pq_decode_wrapper_rejects_bad_shapes_on_the_cpu():
    inp = _pq_inputs(11)
    lut = torch.zeros((2, 2, 2, 8, 16), dtype=torch.uint8)
    sc = torch.ones((2, 2, 2))
    args = (_t(inp["k_codes"]), _t(inp["v_codes"]), _t(inp["v_cb"]))
    with pytest.raises(ValueError):
        tpqk.pq_decode(lut, sc, sc, *args, torch.zeros(3, dtype=torch.int32),
                       chunk=8, out_dtype=torch.float32)
    with pytest.raises(ValueError):
        tpqk.pq_decode(lut[..., :8], sc, sc, *args,
                       torch.zeros(2, dtype=torch.int32), chunk=8,
                       out_dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA kernel only"):
        tpqk.pq_decode(lut, sc, sc, *args, torch.zeros(2, dtype=torch.int32),
                       chunk=8, out_dtype=torch.float32,
                       scores=torch.zeros((2, 2, 2, 32)))


def test_smem_mirror_covers_the_path_shapes():
    # qwen3-1.7b's K8 at M = 64, g = 2, and zamba2-2.7b's at M = 40, g = 1,
    # head_dim 80: well under one block's limit
    assert tpqk.smem_bytes(2, 64, 128, True) < 48 * 1024
    assert tpqk.smem_bytes(1, 40, 80, True) < 48 * 1024
    # the MoE and frontend archs: dbrx-132b (g 6, M 64, head_dim 128),
    # llama4-scout (g 5, M 64, 128), internvl2-1b (g 7, M 32, 64) and
    # musicgen-medium (g 1, M 32, 64), as their configs resolve them
    for arch, shape in (("dbrx-132b", (6, 64, 128)),
                        ("llama4-scout-17b-a16e", (5, 64, 128)),
                        ("internvl2-1b", (7, 32, 64)),
                        ("musicgen-medium", (1, 32, 64))):
        cfg = tconfigs.get_config(arch)
        assert (cfg.n_heads // cfg.n_kv_heads, cfg.resolved_kv_pq_m,
                cfg.resolved_head_dim) == shape
        assert shape[0] <= tpqk.MAX_G and shape[2] <= tpqk.THREADS
        assert tpqk.smem_bytes(*shape, True) < 48 * 1024
        assert tpqk.smem_bytes(*shape, False) < 232448
    # starcoder2-15b's g = 12 (48 heads over 4), the kernel's largest
    assert tpqk.MAX_G == 12
    assert tpqk.smem_bytes(12, 64, 128, True) < 232448
    assert tpqk.smem_bytes(8, 64, 256, False) < 232448


def test_update_exact_and_pq_write_at_the_scalar_position():
    rng = np.random.default_rng(12)
    kc = torch.zeros((2, 8, 2, 16))
    vc = torch.zeros((2, 8, 2, 16))
    kn = _t(rng.normal(0, 1, (2, 2, 16)).astype(np.float32))
    tkvc.update_exact(kc, vc, kn, 2 * kn, torch.tensor(5, dtype=torch.int32))
    assert torch.equal(kc[:, 5], kn) and torch.equal(vc[:, 5], 2 * kn)
    assert not kc[:, [0, 1, 2, 3, 4, 6, 7]].any()
    inp = _pq_inputs(13, smax=8)
    kcod = torch.zeros((2, 8, 2, 4), dtype=torch.uint8)
    vcod = torch.zeros((2, 8, 2, 4), dtype=torch.uint8)
    cb = _t(inp["k_cb"])
    tkvc.update_pq(kcod, vcod, kn, kn, cb, cb, 3)
    want = np.asarray(jkvc.encode_kv(jnp.asarray(kn.numpy()),
                                     jnp.asarray(inp["k_cb"])))
    np.testing.assert_array_equal(kcod[:, 3].numpy(), want)
    assert not kcod[:, [0, 1, 2, 4, 5, 6, 7]].any()


def test_calibrated_codebooks_reduce_reconstruction_error():
    rng = np.random.default_rng(14)
    n, kv, hd, m = 512, 2, 32, 8
    centers = rng.normal(0, 1, (8, kv, hd)).astype(np.float32)
    x = centers[rng.integers(0, 8, n)] + 0.05 * rng.normal(
        0, 1, (n, kv, hd)).astype(np.float32)
    cb = tkvc.calibrate_kv_codebooks(torch.Generator().manual_seed(3), _t(x),
                                     m=m)
    assert cb.shape == (kv, m, 16, hd // m)
    rec = tkvc.decode_kv(tkvc.encode_kv(_t(x), cb), cb)
    rel = float(torch.linalg.norm(rec - _t(x)) / torch.linalg.norm(_t(x)))
    assert rel < 0.2, rel
    # and against random codebooks of the same scale
    rand = _t(rng.normal(0, 1, (kv, m, 16, hd // m)).astype(np.float32))
    rec_r = tkvc.decode_kv(tkvc.encode_kv(_t(x), rand), rand)
    assert rel < float(torch.linalg.norm(rec_r - _t(x))
                       / torch.linalg.norm(_t(x)))


# ---------------------------------------------------------------------------
# the model and the serving path
# ---------------------------------------------------------------------------

def test_interop_lm_round_trip(pair):
    _, _, tcfg, jparams, model = pair
    flat = _flat(jparams)
    back = interop.arrays_from_lm_params(model)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    with pytest.raises(KeyError):
        interop.lm_params_from_arrays({**flat, "extra": flat["ln_f"]}, tcfg,
                                      device="cpu")


def test_init_lm_follows_the_reference_rule(monkeypatch):
    tcfg = tconfigs.get_smoke_config("qwen1.5-32b")
    model = tmodel.init_lm(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    blk = model.stack.blocks[0]
    assert torch.equal(blk.ln1, torch.ones(64))
    assert not blk.attn.bq.any()
    # normal x 1/sqrt(fan_in), fan_in the second-to-last dim: H for wq
    # (d, H, hd), d for wi_up (d, f)
    std = float(blk.attn.wq.std())
    assert abs(std - 1 / np.sqrt(4)) < 0.1 / np.sqrt(4)
    assert abs(float(blk.ffn.wi_up.std()) - 1 / np.sqrt(64)) < 0.1 / 8
    assert abs(float(model.embedding.std()) - 1 / np.sqrt(256)) < 0.01
    assert tmodel.lm_specs(tcfg).keys() == jmodel.lm_specs(
        jconfigs.get_smoke_config("qwen1.5-32b")).keys()
    n = sum(p.numel() for p in model.parameters())
    jshapes = jax.tree.leaves(jmodel.lm_shapes(
        jconfigs.get_smoke_config("qwen1.5-32b")))
    assert n == sum(int(np.prod(s.shape)) for s in jshapes)
    # the card unless the caller asks for the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmodel.init_lm(tcfg, generator=torch.Generator().manual_seed(0))


def test_forward_matches_reference(pair):
    _, jcfg, tcfg, jparams, model = pair
    toks = _prompts(tcfg, seed=15, s=PROMPT)
    want, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = tmodel.forward(model, _t(toks), tcfg)
    _close(got, want, LOGIT_TOL)
    assert float(aux) == 0.0
    # a ragged length takes the full-attention branch
    want, _ = jmodel.forward(jparams, jnp.asarray(toks[:, :37]), jcfg)
    _close(tmodel.forward(model, _t(toks[:, :37]), tcfg)[0], want, LOGIT_TOL)


def _ref_pq_cache(jparams, jcfg, max_seq):
    return jserve.calibrate_pq_cache(jax.random.PRNGKey(1), jparams,
                                     jcfg.replace(kv_pq=True), B, max_seq)


@pytest.mark.parametrize("cache", ["exact", "pq"])
def test_prefill_and_decode_logits_match_reference(pair, cache):
    arch, jcfg, tcfg, jparams, model = pair
    pq = cache == "pq"
    jcfg, tcfg = jcfg.replace(kv_pq=pq), tcfg.replace(kv_pq=pq)
    max_seq = PROMPT + GEN
    prompts = _prompts(tcfg, seed=16)
    jpq = tpq = None
    if pq:
        jpq = _ref_pq_cache(jparams, jcfg, max_seq)
        arrays = {k: np.asarray(getattr(jpq, k).astype(jnp.float32))
                  if "cb" in k else np.asarray(getattr(jpq, k))
                  for k in jpq._fields}
        tpq = interop.pq_cache_from_arrays(arrays, device="cpu")
        back = interop.arrays_from_pq_cache(tpq)
        for k in arrays:
            np.testing.assert_array_equal(back[k], arrays[k])
    jl, jc = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq, pq_cache=jpq)
    tl, tc = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq,
                            pq_cache=tpq)
    _close(tl, jl, LOGIT_TOL, f"{arch} {cache} prefill")
    if pq:
        # the prompt's codes: equal but for near-ties of the distances
        assert np.mean(tc.k_codes.numpy() != np.asarray(jc.k_codes)) <= 0.01
    else:
        _close(tc.k, jc.k, LOGIT_TOL)   # after the stack: a model stage
    step = jax.jit(lambda c, t, p: jmodel.decode_step(jparams, c, t, p, jcfg))
    tok = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)
    for i in range(GEN - 1):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = step(jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tmodel.decode_step(model, tc, _t(tok), _t(pos), tcfg)
        _close(tl, jl, LOGIT_TOL, f"{arch} {cache} decode step {i}")
        tok = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)


def test_serve_batch_tokens_match_reference(pair):
    arch, jcfg, tcfg, jparams, model = pair
    jcfg, tcfg = jcfg.replace(kv_pq=False), tcfg.replace(kv_pq=False)
    prompts = _prompts(tcfg, seed=17)
    want = np.asarray(jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts),
                                         GEN))
    got, logits = tserve.serve_batch(tcfg, model, _t(prompts), GEN,
                                     return_logits=True)
    got = got.numpy()
    assert got.shape == want.shape == (B, GEN)
    # the reference's logits at each of its own steps, teacher-forced
    full, _ = jmodel.forward(jparams, jnp.asarray(
        np.concatenate([prompts, want[:, :-1]], 1)), jcfg)
    ref = np.asarray(full)[:, PROMPT - 1:, :tcfg.vocab]
    for r in range(B):
        for i in range(GEN):
            if got[r, i] == want[r, i]:
                continue
            top2 = np.sort(ref[r, i])[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL * max(1.0, abs(top2[1])), \
                (arch, r, i)
            break   # after a tie the two streams may part
    _close(logits[:, :, :tcfg.vocab][:, :1], ref[:, :1], LOGIT_TOL)


def test_serve_batch_pq_runs_the_plain_decode_on_the_cpu(pair):
    _, _, tcfg, _, model = pair
    before = tpqk.launches
    stats = {}
    toks = tserve.serve_batch(tcfg.replace(kv_pq=True), model,
                              _t(_prompts(tcfg, seed=18)), GEN, stats=stats)
    assert toks.shape == (B, GEN) and int(toks.max()) < tcfg.vocab
    assert tpqk.launches == before      # the CPU takes the plain version
    assert set(stats) == {"calibrate_s", "prefill_s", "decode_s",
                          "decode_steps"}
    assert stats["decode_steps"] == GEN - 1


def test_the_stack_rejects_families_not_ported():
    # an MoE config's blocks hold the routed experts in place of the FFN
    cfg = tconfigs.get_smoke_config("qwen3-1.7b").replace(n_experts=4)
    specs = ttf.attn_block_specs(cfg)
    assert "moe" in specs and "ffn" not in specs
    assert "moe" in tmodel.lm_specs(cfg)["stack"]["blocks"][0]
    assert "ffn" in ttf.attn_block_specs(cfg.replace(n_experts=0))
    # a block type the reference does not have is refused
    with pytest.raises(ValueError):
        tmodel.lm_specs(cfg.replace(block_type="transformer-xl"))
    # every family is served: its stack builds
    for arch in tconfigs.ARCHS:
        assert "stack" in tmodel.lm_specs(tconfigs.get_smoke_config(arch))
