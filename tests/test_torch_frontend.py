"""The port's frontend-stub archs (internvl2-1b [vlm], musicgen-medium
[audio]) held against the JAX reference on the CPU, with and without
``frontend_embeds``.

Both stubs write precomputed patch or frame embeddings (B, F, D) over the
token embeddings of the first F positions; the backbones are the dense
attention family (internvl2: GQA with ``qkv_bias``; musicgen: MHA with the
GELU FFN). Two smoke configs run in f32 (``frontend_len`` 8), inputs from
numpy seeds, the reference's parameters carried across by ``interop``.
Tolerances: logits and caches at atol = rtol = 1e-4 (a stack of f32
stages in another summation order); PQ codes equal but for near-ties of
the distances (at most 1% of them); greedy tokens equal, or a near-tie of
the reference's top two logits.

The reference's PQ prefill (``encode_pq_cache``) and decode step take no
embeddings, so a PQ prefill given some drops them in the reference; the
port mirrors that, and both packages are held to it here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import model as jmodel
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

LOGIT_TOL = 1e-4
B, PROMPT, GEN = 2, 64, 4
ARCHS = ("internvl2-1b", "musicgen-medium")


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


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(arch, reference cfg, port cfg, reference params, port model)."""
    jcfg = jconfigs.get_smoke_config(request.param)
    tcfg = tconfigs.get_smoke_config(request.param)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_arrays(_flat(jparams), tcfg, device="cpu")
    return request.param, jcfg, tcfg, jparams, model


def _prompts(cfg, seed=0, b=B, s=PROMPT):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


def _embeds(cfg, seed, b=B):
    return np.random.default_rng(seed).normal(
        0, 1, (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)


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
        assert got.frontend != "none" and got.frontend_len > 0


@pytest.mark.parametrize("with_embeds", [False, True])
def test_forward_matches_reference(pair, with_embeds):
    arch, jcfg, tcfg, jparams, model = pair
    toks = _prompts(tcfg, seed=20)
    emb = _embeds(tcfg, 21) if with_embeds else None
    want, _ = jmodel.forward(jparams, jnp.asarray(toks), jcfg,
                             frontend_embeds=None if emb is None
                             else jnp.asarray(emb))
    got, aux = tmodel.forward(model, _t(toks), tcfg,
                              frontend_embeds=None if emb is None
                              else _t(emb))
    _close(got, want, LOGIT_TOL, f"{arch} embeds={with_embeds}")
    assert float(aux) == 0.0


def test_embeddings_change_what_they_precede_and_nothing_before(pair):
    _, _, tcfg, _, model = pair
    toks = _t(_prompts(tcfg, seed=22))
    emb = _embeds(tcfg, 23)
    plain, _ = tmodel.forward(model, toks, tcfg)
    with_e, _ = tmodel.forward(model, toks, tcfg, frontend_embeds=_t(emb))
    again, _ = tmodel.forward(model, toks, tcfg, frontend_embeds=_t(emb))
    assert torch.equal(with_e, again)          # equal embeddings, equal logits
    # causal: position 0 now reads an embedding, and every later position
    # attends to it
    assert (with_e - plain).abs().amax(-1).min() > 0
    # a change at the last embedded position moves nothing before it
    emb2 = emb.copy()
    emb2[:, -1] += 1.0
    moved, _ = tmodel.forward(model, toks, tcfg, frontend_embeds=_t(emb2))
    f = tcfg.frontend_len
    assert torch.equal(moved[:, :f - 1], with_e[:, :f - 1])
    assert not torch.equal(moved[:, f - 1:], with_e[:, f - 1:])
    # a config without a frontend ignores them, as the reference does
    cfg = tcfg.replace(frontend="none")
    assert torch.equal(tmodel.forward(model, toks, cfg,
                                      frontend_embeds=_t(emb))[0], plain)


def _ref_pq_cache(jparams, jcfg, max_seq):
    return jserve.calibrate_pq_cache(jax.random.PRNGKey(1), jparams,
                                     jcfg.replace(kv_pq=True), B, max_seq)


def _port_pq(jpq):
    return interop.pq_cache_from_arrays(
        {k: np.asarray(getattr(jpq, k).astype(jnp.float32))
         if "cb" in k else np.asarray(getattr(jpq, k)) for k in jpq._fields},
        device="cpu")


@pytest.mark.parametrize("with_embeds", [False, True])
@pytest.mark.parametrize("cache", ["exact", "pq"])
def test_prefill_and_decode_logits_match_reference(pair, cache, with_embeds):
    arch, jcfg, tcfg, jparams, model = pair
    pq = cache == "pq"
    jcfg, tcfg = jcfg.replace(kv_pq=pq), tcfg.replace(kv_pq=pq)
    max_seq = PROMPT + GEN
    prompts = _prompts(tcfg, seed=24)
    emb = _embeds(tcfg, 25) if with_embeds else None
    jpq = _ref_pq_cache(jparams, jcfg, max_seq) if pq else None
    jl, jc = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq,
                            frontend_embeds=None if emb is None
                            else jnp.asarray(emb), pq_cache=jpq)
    tl, tc = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq,
                            frontend_embeds=None if emb is None else _t(emb),
                            pq_cache=_port_pq(jpq) if pq else None)
    what = f"{arch} {cache} embeds={with_embeds}"
    _close(tl, jl, LOGIT_TOL, f"{what} prefill")
    if pq:
        assert np.mean(tc.k_codes.numpy() != np.asarray(jc.k_codes)) <= 0.01
    else:
        _close(tc.k, jc.k, LOGIT_TOL)
        _close(tc.v, jc.v, LOGIT_TOL)
    step = jax.jit(lambda c, t, p: jmodel.decode_step(jparams, c, t, p, jcfg))
    tok = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)
    for i in range(GEN - 1):
        pos = np.full((B,), PROMPT + i, np.int32)
        jl, jc = step(jc, jnp.asarray(tok), jnp.asarray(pos))
        tl, tc = tmodel.decode_step(model, tc, _t(tok), _t(pos), tcfg)
        _close(tl, jl, LOGIT_TOL, f"{what} decode step {i}")
        tok = np.argmax(np.asarray(jl)[:, :tcfg.vocab], -1).astype(np.int32)


def test_both_packages_drop_the_embeddings_on_a_pq_prefill(pair):
    arch, jcfg, tcfg, jparams, model = pair
    jcfg, tcfg = jcfg.replace(kv_pq=True), tcfg.replace(kv_pq=True)
    max_seq = PROMPT + GEN
    prompts = _prompts(tcfg, seed=26)
    emb = _embeds(tcfg, 27)
    jpq = _ref_pq_cache(jparams, jcfg, max_seq)
    # the reference: prefill returns through encode_pq_cache before it
    # reads the embeddings, so they change nothing
    jl_e, jc_e = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                                max_seq=max_seq,
                                frontend_embeds=jnp.asarray(emb), pq_cache=jpq)
    jl, jc = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq, pq_cache=jpq)
    np.testing.assert_array_equal(np.asarray(jl_e), np.asarray(jl))
    np.testing.assert_array_equal(np.asarray(jc_e.k_codes),
                                  np.asarray(jc.k_codes))
    # the port alike
    tl_e, tc_e = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq,
                                frontend_embeds=_t(emb),
                                pq_cache=_port_pq(jpq))
    tl, tc = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq,
                            pq_cache=_port_pq(jpq))
    assert torch.equal(tl_e, tl)
    assert torch.equal(tc_e.k_codes, tc.k_codes)
    assert torch.equal(tc_e.v_codes, tc.v_codes)
    # while the exact prefill reads them
    exact = tcfg.replace(kv_pq=False)
    with_e, _ = tmodel.prefill(model, _t(prompts), exact, max_seq=max_seq,
                               frontend_embeds=_t(emb))
    assert not torch.equal(with_e, tmodel.prefill(model, _t(prompts), exact,
                                                  max_seq=max_seq)[0])


def test_interop_lm_round_trip(pair):
    _, _, tcfg, jparams, model = pair
    flat = _flat(jparams)
    back = interop.arrays_from_lm_params(model)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


def test_serve_batch_tokens_match_reference(pair):
    arch, jcfg, tcfg, jparams, model = pair
    prompts = _prompts(tcfg, seed=28)
    want = np.asarray(jserve.serve_batch(jcfg, jparams, jnp.asarray(prompts),
                                         GEN))
    got, logits = tserve.serve_batch(tcfg, model, _t(prompts), GEN,
                                     return_logits=True)
    got = got.numpy()
    assert got.shape == want.shape == (B, GEN)
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
            break
    _close(logits[:, :1, :tcfg.vocab], ref[:, :1], LOGIT_TOL)


def test_serve_batch_pq_runs_the_plain_decode_on_the_cpu(pair):
    _, _, tcfg, _, model = pair
    from repro_torch.kernels import pq_decode_kernel as tpqk
    before = tpqk.launches
    stats = {}
    toks = tserve.serve_batch(tcfg.replace(kv_pq=True), model,
                              _t(_prompts(tcfg, seed=29)), GEN, stats=stats)
    assert toks.shape == (B, GEN) and int(toks.max()) < tcfg.vocab
    assert tpqk.launches == before      # the CPU takes the plain version
    assert stats["decode_steps"] == GEN - 1
