"""The port's recurrent LM families (``repro_torch.models.ssm``, ``rwkv6``,
the Mamba2 / zamba2-hybrid and RWKV6 stacks, ``model``, ``launch.serve``)
held against the JAX reference on the CPU.

Three configs run in f32: zamba2-smoke (the hybrid: Mamba2 layers and a
shared attention block every 2), zamba2-smoke with ``shared_attn_every=0``
(the pure Mamba2 stack) and rwkv6-smoke; inputs come from numpy seeds and
the reference's parameters and caches cross through ``interop``.
Tolerances: the chunked scans, the blocks and the decode steps at atol =
rtol = 1e-5 (f32, the same ops in another summation order); the model's
logits and caches at 1e-4 (a whole stack of such stages); the PQ hybrid's
codes equal up to near-ties of the reference's distances (at most 1% of
the codes), its decode logits at 1e-4 with f32 codebooks and at 2e-3 of
the largest |logit| with bf16 ones (as calibration makes them: both
packages round each chunk's value sum to bf16, and a sum that lands on a
rounding boundary in one summation order may round the other way in the
other); greedy tokens equal, or a near-tie of the reference's top two
logits. The reference's own consistency checks run on the port at the
reference's tolerances: the scans against the naive recurrence at 1e-3,
decode against the teacher-forced forward at 5e-2 of the largest |logit|.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro.models import rwkv6 as jrwkv
from repro.models import ssm as jssm
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import kvcache as tkvc
from repro_torch.models import model as tmodel
from repro_torch.models import rwkv6 as trwkv
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttf

TOL = 1e-5
LOGIT_TOL = 1e-4
BF16_TOL = 2e-3         # of the largest |logit|: bf16 roundings of a sum
SCAN_TOL = 1e-3         # the reference's own naive-recurrence tolerance
FORWARD_RTOL = 5e-2     # the reference's decode-vs-forward tolerance
B, PROMPT, GEN = 2, 24, 4
# (name, arch, config overrides)
FAMILIES = {"hybrid": ("zamba2-2.7b", {}),
            "mamba2": ("zamba2-2.7b", {"shared_attn_every": 0}),
            "rwkv6": ("rwkv6-3b", {})}
NEW_ARCHS = ("zamba2-2.7b", "rwkv6-3b", "nemotron-4-15b", "starcoder2-15b")


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), atol=tol,
                               rtol=tol, err_msg=what)


def _flat(tree, prefix="", leaf=np.asarray):
    """A reference tree as /-joined path keys -> leaf(value)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/", leaf))
        else:
            out[f"{prefix}{k}"] = leaf(v)
    return out


def _cache_arrays(cache) -> dict:
    return {k: np.asarray(v.astype(jnp.float32)) if v.dtype == jnp.bfloat16
            else np.asarray(v) for k, v in cache.items()}


def _close_cache(got: dict, want, tol, what=""):
    assert sorted(got) == sorted(want), what
    for k in want:
        if "codes" in k:
            continue
        _close(got[k].float(), np.asarray(want[k], np.float32), tol,
               f"{what} {k}")


@functools.lru_cache(maxsize=None)
def _family(name: str):
    """(family, reference cfg, port cfg, reference params, port model), the
    exact cache."""
    arch, kw = FAMILIES[name]
    jcfg = jconfigs.get_smoke_config(arch).replace(kv_pq=False, **kw)
    tcfg = tconfigs.get_smoke_config(arch).replace(kv_pq=False, **kw)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_arrays(_flat(jparams), tcfg, device="cpu")
    return name, jcfg, tcfg, jparams, model


@pytest.fixture(params=sorted(FAMILIES))
def fam(request):
    return _family(request.param)


@pytest.fixture(scope="module")
def hybrid():
    arch, _ = FAMILIES["hybrid"]
    jcfg, tcfg = (jconfigs.get_smoke_config(arch),
                  tconfigs.get_smoke_config(arch))
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_arrays(_flat(jparams), tcfg, device="cpu")
    return jcfg, tcfg, jparams, model


def _prompts(cfg, seed=0, b=B, s=PROMPT):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
            {f: getattr(want, f) for f in want.__dataclass_fields__}
        assert got.param_count() == want.param_count()


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_specs_equal_the_references_shapes(name):
    arch, kw = FAMILIES[name]
    tcfg = tconfigs.get_smoke_config(arch).replace(**kw)
    model = tmodel.init_lm(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    flat = interop.arrays_from_lm_params(model)
    jshapes = _flat(jmodel.lm_shapes(jconfigs.get_smoke_config(arch).replace(
        **kw)), leaf=lambda v: tuple(v.shape))
    assert {k: v.shape for k, v in flat.items()} == jshapes


# ---------------------------------------------------------------------------
# the chunked scans
# ---------------------------------------------------------------------------

# (b, s, nh, hd, g, ds, chunk, with h0): padded and unpadded, g > 1
SSD_CASES = [(2, 32, 4, 8, 1, 16, 8, False), (1, 21, 4, 8, 2, 8, 8, True),
             (2, 5, 2, 4, 1, 4, 16, True)]


@pytest.mark.parametrize("case", SSD_CASES)
def test_ssd_chunked_matches_reference(case):
    b, s, nh, hd, g, ds, chunk, with_h0 = case
    rng = np.random.default_rng(1)
    xh = rng.normal(0, 0.5, (b, s, nh, hd)).astype(np.float32)
    log_a = (-np.abs(rng.normal(0, 1, (b, s, nh))) * 0.3).astype(np.float32)
    bm, cm = (rng.normal(0, 0.5, (b, s, g, ds)).astype(np.float32)
              for _ in range(2))
    h0 = rng.normal(0, 1, (b, nh, hd, ds)).astype(np.float32) \
        if with_h0 else None
    want = jssm.ssd_chunked(*(jnp.asarray(x) for x in (xh, log_a, bm, cm)),
                            chunk, None if h0 is None else jnp.asarray(h0))
    got = tssm.ssd_chunked(_t(xh), _t(log_a), _t(bm), _t(cm), chunk,
                           None if h0 is None else _t(h0))
    for gt, w in zip(got, want):
        _close(gt, w, TOL)
    assert got[1].dtype == torch.float32


# (b, s, nh, hd, chunk, with s0)
WKV_CASES = [(2, 24, 2, 8, 8, False), (1, 19, 3, 4, 8, True),
             (2, 6, 2, 8, 16, True)]


@pytest.mark.parametrize("case", WKV_CASES)
def test_wkv6_chunked_matches_reference(case):
    b, s, nh, hd, chunk, with_s0 = case
    rng = np.random.default_rng(2)
    r, k, v = (rng.normal(0, 0.5, (b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    log_w = (-np.abs(rng.normal(0, 1, (b, s, nh, hd))) * 0.3).astype(
        np.float32)
    u = rng.normal(0, 0.5, (nh, hd)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, nh, hd, hd)).astype(np.float32) \
        if with_s0 else None
    want = jrwkv.wkv6_chunked(*(jnp.asarray(x) for x in (r, k, v, log_w, u)),
                              chunk, None if s0 is None else jnp.asarray(s0))
    got = trwkv.wkv6_chunked(_t(r), _t(k), _t(v), _t(log_w), _t(u), chunk,
                             None if s0 is None else _t(s0))
    for gt, w in zip(got, want):
        _close(gt, w, TOL)


def test_ssd_chunked_matches_the_naive_recurrence():
    """The reference's own check, on the port: SSD chunked == a token-by-
    token linear recurrence (f64 numpy) at 1e-3."""
    rng = np.random.default_rng(3)
    b, s, nh, hd, g, ds, chunk = 2, 32, 4, 8, 1, 16, 8
    xh = rng.normal(0, 0.5, (b, s, nh, hd)).astype(np.float32)
    log_a = (-np.abs(rng.normal(0, 1, (b, s, nh))) * 0.3).astype(np.float32)
    bm, cm = (rng.normal(0, 0.5, (b, s, g, ds)).astype(np.float32)
              for _ in range(2))
    y, h_final = tssm.ssd_chunked(_t(xh), _t(log_a), _t(bm), _t(cm), chunk)
    h = np.zeros((b, nh, hd, ds))
    a = np.exp(log_a.astype(np.float64))
    bh = np.repeat(bm.astype(np.float64), nh // g, axis=2)
    ch = np.repeat(cm.astype(np.float64), nh // g, axis=2)
    ys = []
    for t in range(s):
        h = h * a[:, t][:, :, None, None] + np.einsum(
            "bhp,bhn->bhpn", xh[:, t].astype(np.float64), bh[:, t])
        ys.append(np.einsum("bhpn,bhn->bhp", h, ch[:, t]))
    _close(y, np.stack(ys, axis=1), SCAN_TOL)
    _close(h_final, h, SCAN_TOL)


def test_wkv6_chunked_matches_the_naive_recurrence():
    """The reference's own check, on the port: WKV6 chunked == the per-token
    recurrence with the u-bonus diagonal (f64 numpy) at 1e-3."""
    rng = np.random.default_rng(4)
    b, s, nh, hd, chunk = 2, 24, 2, 8, 8
    r, k, v = (rng.normal(0, 0.5, (b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    log_w = (-np.abs(rng.normal(0, 1, (b, s, nh, hd))) * 0.3).astype(
        np.float32)
    u = rng.normal(0, 0.5, (nh, hd)).astype(np.float32)
    y, s_final = trwkv.wkv6_chunked(_t(r), _t(k), _t(v), _t(log_w), _t(u),
                                    chunk)
    st = np.zeros((b, nh, hd, hd))
    w = np.exp(log_w.astype(np.float64))
    ys = []
    for t in range(s):
        kv = np.einsum("bhi,bhj->bhij", k[:, t].astype(np.float64),
                       v[:, t].astype(np.float64))
        ys.append(np.einsum("bhi,bhij->bhj", r[:, t].astype(np.float64),
                            st + u.astype(np.float64)[None, :, :, None] * kv))
        st = st * w[:, t][..., None] + kv
    _close(y, np.stack(ys, axis=1), SCAN_TOL)
    _close(s_final, st, SCAN_TOL)


def test_both_packages_overflow_wkv6_at_chunk_128():
    """ROADMAP Queue 3: at log_w = -1 a step and the published rwkv_chunk
    of 128, k * exp(-a) overflows f32 in both packages (the output is not
    finite, the final state is); chunk 64 stays finite in both."""
    rng = np.random.default_rng(5)
    b, s, nh, hd = 1, 256, 2, 8
    r, k, v = (rng.normal(0, 1, (b, s, nh, hd)).astype(np.float32)
               for _ in range(3))
    log_w = np.full((b, s, nh, hd), -1.0, np.float32)
    u = rng.normal(0, 0.5, (nh, hd)).astype(np.float32)
    for chunk, finite in ((128, False), (64, True)):
        jy, js = jrwkv.wkv6_chunked(
            *(jnp.asarray(x) for x in (r, k, v, log_w, u)), chunk)
        ty, ts = trwkv.wkv6_chunked(_t(r), _t(k), _t(v), _t(log_w), _t(u),
                                    chunk)
        assert bool(np.isfinite(np.asarray(jy)).all()) is finite
        assert bool(torch.isfinite(ty).all()) is finite
        assert np.isfinite(np.asarray(js)).all() and bool(
            torch.isfinite(ts).all())
        if finite:
            _close(ty, jy, TOL)


# ---------------------------------------------------------------------------
# the blocks
# ---------------------------------------------------------------------------

def _layer0(jparams, key):
    return jax.tree.map(lambda a: a[0], jparams["stack"]["blocks"])[key]


@pytest.mark.parametrize("name", ["hybrid", "mamba2"])
def test_mamba_block_and_its_state_match_reference(name):
    _, jcfg, tcfg, jparams, model = _family(name)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 19, tcfg.d_model)).astype(np.float32)
    want, wst = jssm.mamba_block(_layer0(jparams, "mamba"), jnp.asarray(x),
                                 jcfg, return_state=True)
    got, gst = tssm.mamba_block(model.stack.blocks[0].mamba, _t(x), tcfg,
                                return_state=True)
    _close(got, want, TOL)
    for key in ("h", "conv"):
        _close(gst[key], wst[key], TOL, key)
    _close(tssm.mamba_block(model.stack.blocks[0].mamba, _t(x), tcfg), want,
           TOL)


@pytest.mark.parametrize("name", ["hybrid", "mamba2"])
def test_mamba_decode_step_matches_reference(name):
    _, jcfg, tcfg, jparams, model = _family(name)
    rng = np.random.default_rng(7)
    st0 = tssm.mamba_state_init(tcfg, 2, torch.float32, torch.device("cpu"))
    state = {k: rng.normal(0, 1, tuple(v.shape)).astype(np.float32)
             for k, v in st0.items()}
    p = _layer0(jparams, "mamba")
    for step in range(3):
        x = rng.normal(0, 1, (2, tcfg.d_model)).astype(np.float32)
        want, wst = jssm.mamba_decode_step(
            p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
            jcfg)
        got, gst = tssm.mamba_decode_step(
            model.stack.blocks[0].mamba, _t(x),
            {k: _t(v) for k, v in state.items()}, tcfg)
        _close(got, want, TOL, f"step {step}")
        for key in ("h", "conv"):
            _close(gst[key], wst[key], TOL, f"step {step} {key}")
        state = {k: np.asarray(v) for k, v in wst.items()}


def test_rwkv_time_mix_and_channel_mix_match_reference():
    _, jcfg, tcfg, jparams, model = _family("rwkv6")
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (2, 19, tcfg.d_model)).astype(np.float32)
    prev = rng.normal(0, 1, (2, tcfg.d_model)).astype(np.float32)
    s0 = rng.normal(0, 1, (2, tcfg.rwkv_nheads, tcfg.rwkv_head_dim,
                           tcfg.rwkv_head_dim)).astype(np.float32)
    p, tp = _layer0(jparams, "rwkv"), model.stack.blocks[0].rwkv
    for pv, s in ((None, None), (prev, s0)):
        want = jrwkv.rwkv_time_mix(p, jnp.asarray(x), jcfg,
                                   None if pv is None else jnp.asarray(pv),
                                   None if s is None else jnp.asarray(s))
        got = trwkv.rwkv_time_mix(tp, _t(x), tcfg,
                                  None if pv is None else _t(pv),
                                  None if s is None else _t(s))
        for gt, w in zip(got, want):
            _close(gt, w, TOL)
        _close(trwkv.rwkv_channel_mix(tp, _t(x),
                                      None if pv is None else _t(pv)),
               jrwkv.rwkv_channel_mix(p, jnp.asarray(x),
                                      None if pv is None else jnp.asarray(pv)),
               TOL)


def test_rwkv_decode_step_matches_reference():
    _, jcfg, tcfg, jparams, model = _family("rwkv6")
    rng = np.random.default_rng(9)
    st0 = trwkv.rwkv_state_init(tcfg, 2, torch.float32, torch.device("cpu"))
    state = {k: rng.normal(0, 1, tuple(v.shape)).astype(np.float32)
             for k, v in st0.items()}
    p, tp = _layer0(jparams, "rwkv"), model.stack.blocks[0].rwkv
    for step in range(3):
        x = rng.normal(0, 1, (2, tcfg.d_model)).astype(np.float32)
        want, wst = jrwkv.rwkv_decode_step(
            p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()},
            jcfg)
        got, gst = trwkv.rwkv_decode_step(
            tp, _t(x), {k: _t(v) for k, v in state.items()}, tcfg)
        _close(got, want, TOL, f"step {step}")
        for key in wst:
            _close(gst[key], wst[key], TOL, f"step {step} {key}")
        _close(trwkv.rwkv_channel_mix_step(tp, _t(x), _t(state["cm_prev"])),
               jrwkv.rwkv_channel_mix_step(p, jnp.asarray(x),
                                           jnp.asarray(state["cm_prev"])),
               TOL)
        state = {k: np.asarray(v) for k, v in wst.items()}


# ---------------------------------------------------------------------------
# the model, its caches and the serving path
# ---------------------------------------------------------------------------

def test_forward_matches_reference(fam):
    name, jcfg, tcfg, jparams, model = fam
    toks = _prompts(tcfg, seed=10, s=37)   # ragged: the scans pad a chunk
    want, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = tmodel.forward(model, _t(toks), tcfg)
    _close(got, want, LOGIT_TOL, name)
    assert float(aux) == 0.0


def test_interop_round_trips_params_and_caches(fam):
    name, jcfg, tcfg, jparams, model = fam
    flat = _flat(jparams)
    back = interop.arrays_from_lm_params(model)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    with pytest.raises(KeyError):
        interop.lm_params_from_arrays({**flat, "extra": flat["ln_f"]}, tcfg,
                                      device="cpu")
    # a reference cache (random values) crosses both ways unchanged
    jcache = jmodel.init_cache(jcfg, B, 16)
    rng = np.random.default_rng(11)
    arrays = {k: rng.normal(0, 1, v.shape).astype(np.float32)
              for k, v in _cache_arrays(jcache).items()}
    tcache = interop.lm_cache_from_arrays(arrays, tcfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in tcache.items()} == \
        {k: tuple(v.shape) for k, v in jcache.items()}
    assert all(tcache[k].dtype == torch.float32 for k in tcache)
    back = interop.arrays_from_lm_cache(tcache)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])


def test_interop_round_trips_the_pq_hybrid_cache(hybrid):
    jcfg, tcfg, _, _ = hybrid
    jcache = jmodel.init_cache(jcfg, B, 16, key=jax.random.PRNGKey(2))
    arrays = _cache_arrays(jcache)
    tcache = interop.lm_cache_from_arrays(arrays, tcfg, device="cpu")
    assert tcache["attn_k_codes"].dtype == torch.uint8
    assert tcache["attn_k_cb"].dtype == torch.bfloat16   # as the reference
    assert tcache["h"].dtype == torch.float32
    back = interop.arrays_from_lm_cache(tcache)
    assert sorted(back) == sorted(arrays)
    for k in arrays:
        np.testing.assert_array_equal(back[k], arrays[k])
    want = tmodel.init_cache(tcfg, B, 16, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in want.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in tcache.items()}


def _decode_both(jparams, model, jcfg, tcfg, jc, tc, first, what,
                 bf16=False):
    """GEN - 1 greedy decode steps on both packages from their caches
    (the reference's tokens fed to both), logits and caches compared; with
    ``bf16`` (bf16 codebooks) the logits within BF16_TOL of the largest."""
    step = jax.jit(lambda c, t, p: jmodel.decode_step(jparams, c, t, p, jcfg))
    tok = first
    for i in range(GEN - 1):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = step(jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc2 = tmodel.decode_step(model, tc, _t(tok), _t(pos), tcfg)
        assert tc2 is tc                       # updated in place
        if bf16:
            want = np.asarray(jl)
            assert float(np.abs(tl.numpy() - want).max()) <= \
                BF16_TOL * float(np.abs(want).max()), f"{what} step {i}"
        else:
            _close(tl, jl, LOGIT_TOL, f"{what} decode step {i}")
        _close_cache(tc, jc, LOGIT_TOL, f"{what} step {i}")
        tok = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)
    return jc, tc


def test_prefill_and_decode_match_reference(fam):
    name, jcfg, tcfg, jparams, model = fam
    max_seq = PROMPT + GEN
    prompts = _prompts(tcfg, seed=12)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq)
    tl, tc = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq)
    _close(tl, jl, LOGIT_TOL, f"{name} prefill")
    _close_cache(tc, jc, LOGIT_TOL, f"{name} prefill")
    first = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)
    _decode_both(jparams, model, jcfg, tcfg, jc, tc, first, name)


def _codebooks(tcfg, model, prompts, max_seq, dtype):
    """The hybrid's (G, KV, M, 16, dsub) codebooks, calibrated a group at a
    time on the exact prefill's shared-attention K/V, in ``dtype``."""
    _, exact = tmodel.prefill(model, _t(prompts), tcfg.replace(kv_pq=False),
                              max_seq=max_seq)
    m, s = tcfg.resolved_kv_pq_m, prompts.shape[1]
    cbs = {}
    for name in ("attn_k", "attn_v"):
        x = exact[name][:, :, :s]
        g, b, _, kv, hd = x.shape
        cbs[name + "_cb"] = torch.stack([tkvc.calibrate_kv_codebooks(
            torch.Generator().manual_seed(gi), x[gi].reshape(b * s, kv, hd),
            m) for gi in range(g)]).to(dtype)
    return cbs


@pytest.mark.parametrize("cb_dtype", ["float32", "bfloat16"])
def test_pq_hybrid_prefill_and_decode_match_reference(hybrid, cb_dtype):
    """The reference's PQ hybrid path (``mamba_stack_prefill_pq`` and the PQ
    branch of ``mamba_stack_decode``), which only ``prefill(pq_cache=...)``
    reaches, against the port's (the plain K8 version on the CPU)."""
    jcfg, tcfg, jparams, model = hybrid
    assert tcfg.kv_pq and tcfg.shared_attn_every
    max_seq = PROMPT + GEN
    prompts = _prompts(tcfg, seed=13)
    tdt = getattr(torch, cb_dtype)
    cbs = _codebooks(tcfg, model, prompts, max_seq, tdt)
    jcb = {k: jnp.asarray(v.float().numpy()).astype(cb_dtype)
           for k, v in cbs.items()}
    jl, jc = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq, pq_cache=jcb)
    tl, tc = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq,
                            pq_cache=cbs)
    _close(tl, jl, LOGIT_TOL, "pq hybrid prefill")
    _close_cache(tc, jc, LOGIT_TOL, "pq hybrid prefill")
    for key in ("attn_k_codes", "attn_v_codes"):
        # equal but for near-ties of the distances
        assert np.mean(tc[key].numpy() != np.asarray(jc[key])) <= 0.01, key
    # decode from the reference's own cache, carried across
    arrays = _cache_arrays(jc)
    tc = interop.lm_cache_from_arrays(arrays, tcfg, device="cpu")
    tc.update({k: _t(arrays[k]).to(tdt) for k in ("attn_k_cb", "attn_v_cb")})
    first = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)
    jc, tc = _decode_both(jparams, model, jcfg, tcfg, jc, tc, first,
                          f"pq hybrid, {cb_dtype} codebooks",
                          bf16=cb_dtype == "bfloat16")
    for key in ("attn_k_codes", "attn_v_codes"):
        np.testing.assert_array_equal(tc[key].numpy()[:, :, PROMPT:],
                                      np.asarray(jc[key])[:, :, PROMPT:])
    # the exact prefill refuses a PQ hybrid, as the reference's does
    with pytest.raises(NotImplementedError, match="hybrid PQ prefill"):
        ttf.mamba_stack_prefill(model.stack, model.embedding[_t(prompts)
                                                             .long()],
                                tcfg, None, max_seq)


def test_serve_batch_tokens_match_reference(fam):
    name, jcfg, tcfg, jparams, model = fam
    prompts = _prompts(tcfg, seed=14)
    want = np.asarray(jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts),
                                         GEN))
    stats = {}
    got, logits = tserve.serve_batch(tcfg, model, _t(prompts), GEN,
                                     return_logits=True, stats=stats)
    got = got.numpy()
    assert got.shape == want.shape == (B, GEN)
    assert "capture_s" not in stats     # the CPU runs the step eagerly
    full, _ = jmodel.forward(jparams, jnp.asarray(
        np.concatenate([prompts, want[:, :-1]], 1)), jcfg)
    ref = np.asarray(full)[:, PROMPT - 1:, :tcfg.vocab]
    for r in range(B):
        for i in range(GEN):
            if got[r, i] == want[r, i]:
                continue
            top2 = np.sort(ref[r, i])[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL * max(1.0, abs(top2[1])), \
                (name, r, i)
            break   # after a tie the two streams may part
    _close(logits[:, :1, :tcfg.vocab], ref[:, :1], LOGIT_TOL)


def test_both_packages_refuse_to_serve_the_pq_hybrid(hybrid):
    """ROADMAP Queue 3: the reference's serve_batch calibrates codebooks for
    the attention family only, so zamba2's own config (kv_pq) fails in its
    prefill; the port refuses up front and names the gap."""
    jcfg, tcfg, jparams, model = hybrid
    prompts = _prompts(tcfg, seed=15)
    with pytest.raises(AssertionError, match="calibrated codebooks"):
        jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts), GEN)
    with pytest.raises(NotImplementedError, match="attention family only"):
        tserve.serve_batch(tcfg, model, _t(prompts), GEN)


def test_decode_matches_teacher_forced_forward(fam):
    """The reference's own consistency check, on the port: decode from an
    empty cache, token by token, against the teacher-forced forward."""
    name, _, tcfg, _, model = fam
    b, s = 2, 32
    tokens = _t(_prompts(tcfg, seed=16, b=b, s=s))
    full, _ = tmodel.forward(model, tokens, tcfg)
    cache = tmodel.init_cache(tcfg, b, s, device="cpu")
    errs = []
    for i in range(s - 1):
        pos = torch.full((b,), i, dtype=torch.int32)
        logits, cache = tmodel.decode_step(model, cache, tokens[:, i], pos,
                                           tcfg)
        errs.append(float((logits - full[:, i]).abs().max()))
    assert max(errs) / (float(full.abs().max()) + 1e-9) < FORWARD_RTOL, name


def test_prefill_then_decode_continues_correctly(fam):
    """The reference's own check, on the port: prefill(prompt) then one
    decode step == forward(prompt + next) at the last two positions."""
    name, _, tcfg, _, model = fam
    b, s = 2, 24
    tokens = _t(_prompts(tcfg, seed=17, b=b, s=s + 1))
    full, _ = tmodel.forward(model, tokens, tcfg)
    scale = float(full.abs().max()) + 1e-9
    logits_p, cache = tmodel.prefill(model, tokens[:, :s], tcfg,
                                     max_seq=s + 4)
    assert float((logits_p - full[:, s - 1]).abs().max()) / scale < \
        FORWARD_RTOL, name
    logits_d, _ = tmodel.decode_step(model, cache, tokens[:, s],
                                     torch.full((b,), s, dtype=torch.int32),
                                     tcfg)
    assert float((logits_d - full[:, s]).abs().max()) / scale < \
        FORWARD_RTOL, name
