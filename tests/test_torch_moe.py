"""The port's MoE FFN (``repro_torch.models.moe``) and the MoE archs
(dbrx-132b, llama4-scout-17b-a16e) held against the JAX reference on the
CPU.

Two smoke configs run in f32: dbrx-smoke (softmax router, top-2 of 4
experts, swiglu) and llama4-scout-smoke (sigmoid router, top-1 of 4, a
shared expert), and dbrx-smoke's gelu and relu2 variants for the expert
FFN's other branches. Inputs come from numpy seeds; the reference's
parameters cross through ``interop``.

The dispatch maps (``idx_k``, ``tok_for_slot``, ``slot_valid``,
``es_tok``, ``ps_tok``, ``keep_tok``) are integers and held bit for bit:
the reference's are captured at its ``_dispatch`` and ``_combine``, the
port's computed by ``moe.route`` from the reference's own router gates
(carried through numpy), so a tie or a drop is decided on the same
values in both. Cases: the published capacity (which drops at these
sizes), a capacity factor of 0.25 (most entries dropped), gates tied in
pairs, all gates equal, and bf16 logits (where a sigmoid router ties
often). Tolerances: the FFN's output at atol = rtol = 1e-5 and the aux
loss at 1e-6 (f32, other summation orders); the model's logits at 1e-4;
greedy tokens equal, or a near-tie of the reference's top two logits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve
from repro.models import layers as jll
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tll
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttf

TOL = 1e-5
AUX_TOL = 1e-6
LOGIT_TOL = 1e-4
B, PROMPT, GEN = 2, 64, 4
ARCHS = ("dbrx-132b", "llama4-scout-17b-a16e")
# (arch, config overrides) of the FFN-level cases
VARIANTS = {"dbrx": ("dbrx-132b", {}),
            "llama4": ("llama4-scout-17b-a16e", {}),
            "dbrx-gelu": ("dbrx-132b", {"mlp_type": "gelu"}),
            "dbrx-relu2": ("dbrx-132b", {"mlp_type": "relu2"})}
MAPS = ("tok_for_slot", "slot_valid", "es_tok", "ps_tok", "keep_tok")


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


def _cfgs(arch, **kw):
    return (jconfigs.get_smoke_config(arch).replace(**kw),
            tconfigs.get_smoke_config(arch).replace(**kw))


def _moe_params(variant, seed=0, dtype=jnp.float32):
    """(reference cfg, port cfg, reference MoE params, port module)."""
    arch, kw = VARIANTS[variant]
    jcfg, tcfg = _cfgs(arch, **kw)
    jp = jll.init_params(jax.random.PRNGKey(seed), jmoe.moe_specs(jcfg),
                         dtype)
    tp = tll.Params(tmoe.moe_specs(tcfg), dtype=torch.float32,
                    device=torch.device("cpu"))
    with torch.no_grad():
        for name, p in tp.named_parameters():
            p.copy_(_t(np.asarray(jp[name], np.float32)))
    return jcfg, tcfg, jp, tp


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).normal(0, 1, (b, s, cfg.d_model)
                                              ).astype(np.float32)


# ---------------------------------------------------------------------------
# configs and specs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference(arch):
    for get in ("get_config", "get_smoke_config"):
        want = getattr(jconfigs, get)(arch)
        got = getattr(tconfigs, get)(arch)
        assert {f: getattr(got, f) for f in got.__dataclass_fields__} == \
            {f: getattr(want, f) for f in want.__dataclass_fields__}
        assert got.param_count() == want.param_count()
        assert got.resolved_kv_pq_m == want.resolved_kv_pq_m


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_moe_specs_equal_the_references_shapes(variant):
    arch, kw = VARIANTS[variant]
    jcfg, tcfg = _cfgs(arch, **kw)
    want = {k: (s.shape, s.init, s.scale)
            for k, s in jmoe.moe_specs(jcfg).items()}
    got = {k: (s.shape, s.init, s.scale)
           for k, s in tmoe.moe_specs(tcfg).items()}
    assert got == want
    # the whole model: every parameter of the reference, stacked per layer
    model = tmodel.init_lm(tcfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    n = sum(p.numel() for p in model.parameters())
    assert n == sum(int(np.prod(s.shape))
                    for s in jax.tree.leaves(jmodel.lm_shapes(jcfg)))


def test_num_groups_matches_reference():
    for arch in ARCHS:
        for cfg in (jconfigs.get_config(arch), jconfigs.get_smoke_config(arch)):
            tcfg = tconfigs.get_config(arch) if cfg.d_model > 64 else \
                tconfigs.get_smoke_config(arch)
            # decode (t = B), prefill (t = B·S) and teacher-forced lengths
            for t in (1, 2, 7, 8, 12, 24, 128, 8 * 2048, 8 * 2063, 2 * 67):
                assert tmoe._num_groups(tcfg, t) == jmoe._num_groups(cfg, t)
    cfg = tconfigs.get_config("dbrx-132b")
    assert tmoe._num_groups(cfg, 8) == 8            # decode at B = 8
    assert tmoe._num_groups(cfg, 8 * 2048) == 32    # prefill at B·S
    assert tmoe._num_groups(cfg, 8 * 2063) == 8


# ---------------------------------------------------------------------------
# the FFN and its dispatch maps
# ---------------------------------------------------------------------------

def _capture_reference(monkeypatch):
    """Record the reference's slot maps and gates where its single-device
    ``_dispatch`` and ``_combine`` receive them."""
    seen = {}
    dispatch, combine = jmoe._dispatch, jmoe._combine

    def rec_dispatch(xg, tok_for_slot, slot_valid):
        seen.update(tok_for_slot=np.asarray(tok_for_slot),
                    slot_valid=np.asarray(slot_valid))
        return dispatch(xg, tok_for_slot, slot_valid)

    def rec_combine(yb, es_tok, ps_tok, keep_tok, gates):
        seen.update(es_tok=np.asarray(es_tok), ps_tok=np.asarray(ps_tok),
                    keep_tok=np.asarray(keep_tok), gates=np.asarray(gates))
        return combine(yb, es_tok, ps_tok, keep_tok, gates)

    monkeypatch.setattr(jmoe, "_dispatch", rec_dispatch)
    monkeypatch.setattr(jmoe, "_combine", rec_combine)
    return seen


def _ref_gates(jp, x, cfg):
    """The reference's router gates, by its own lines (``moe.py:168-180``),
    as (G, Tg, E) f32."""
    b, s, d = x.shape
    g = jmoe._num_groups(cfg, b * s)
    xg = x.reshape(g, b * s // g, d)
    logits = jnp.einsum("gtd,de->gte", xg, jp["router"]).astype(jnp.float32)
    if cfg.router_act == "sigmoid":
        return jax.nn.sigmoid(logits)
    return jax.nn.softmax(logits, axis=-1)


# (variant, capacity_factor or None, router edit, dtype, (B, S))
ROUTE_CASES = {
    "dbrx": ("dbrx", None, None, "float32", (2, 64)),
    "llama4": ("llama4", None, None, "float32", (2, 64)),
    "dbrx-decode": ("dbrx", None, None, "float32", (8, 1)),
    "llama4-drops": ("llama4", 0.25, None, "float32", (2, 64)),
    "dbrx-drops": ("dbrx", 0.25, None, "float32", (3, 40)),
    "dbrx-pair-ties": ("dbrx", None, "pairs", "float32", (2, 64)),
    "llama4-pair-ties": ("llama4", None, "pairs", "float32", (2, 64)),
    "dbrx-all-tied": ("dbrx", None, "zero", "float32", (2, 64)),
    "llama4-all-tied": ("llama4", None, "zero", "float32", (2, 64)),
    "llama4-bf16": ("llama4", None, None, "bfloat16", (4, 64)),
}


@pytest.mark.parametrize("case", sorted(ROUTE_CASES))
def test_dispatch_maps_bit_for_bit(case, monkeypatch):
    variant, cf, edit, dtype, (b, s) = ROUTE_CASES[case]
    seed = sorted(ROUTE_CASES).index(case)
    jcfg, tcfg, jp, _ = _moe_params(variant)
    if cf is not None:
        jcfg, tcfg = (c.replace(capacity_factor=cf) for c in (jcfg, tcfg))
    router = np.array(jp["router"])
    if edit == "pairs":      # experts 2i and 2i + 1 score alike
        router[:, 1::2] = router[:, 0::2]
    elif edit == "zero":     # every gate equal
        router[:] = 0
    jp = {**jp, "router": jnp.asarray(router)}
    jp = jax.tree.map(lambda a: a.astype(dtype), jp)
    x = jnp.asarray(_x(jcfg, b, s, seed=seed)).astype(dtype)
    seen = _capture_reference(monkeypatch)
    jmoe.moe_ffn(jp, x, jcfg)
    gates_all = _ref_gates(jp, x, jcfg)
    idx_want = np.asarray(jax.lax.top_k(gates_all, jcfg.n_experts_active)[1])
    r = tmoe.route(_t(np.asarray(gates_all)), tcfg)
    np.testing.assert_array_equal(r.idx_k.numpy(), idx_want)
    for name in MAPS:
        np.testing.assert_array_equal(getattr(r, name).numpy(), seen[name],
                                      err_msg=name)
    _close(r.gate_k.to(getattr(torch, dtype)).float(),
           np.asarray(seen["gates"], np.float32), TOL)
    keep = seen["keep_tok"]
    if cf is not None or edit == "zero":
        assert not keep.all()      # the case drops
    if edit is not None or dtype == "bfloat16":
        g = np.asarray(gates_all)
        top = np.sort(g, -1)[..., ::-1]
        assert (top[..., :-1] == top[..., 1:]).any()   # the case ties


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("shape", [(2, 64), (8, 1), (3, 40)])
def test_moe_ffn_matches_reference(variant, shape):
    jcfg, tcfg, jp, tp = _moe_params(variant)
    b, s = shape
    x = _x(tcfg, b, s, seed=b * 100 + s)
    want, aux_w = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, _t(x), tcfg)
    assert got.shape == (b, s, tcfg.d_model)
    _close(got, want, TOL, variant)
    _close(aux, aux_w, AUX_TOL, f"{variant} aux")


def test_moe_ffn_with_forced_drops_matches_reference():
    jcfg, tcfg, jp, tp = _moe_params("dbrx")
    jcfg, tcfg = (c.replace(capacity_factor=0.25) for c in (jcfg, tcfg))
    x = _x(tcfg, 2, 64, seed=7)
    want, aux_w = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    got, aux = tmoe.moe_ffn(tp, _t(x), tcfg)
    _close(got, want, TOL)
    _close(aux, aux_w, AUX_TOL)
    # a dropped token's routed output is zero: rows with every k dropped
    g = tmoe._num_groups(tcfg, 128)
    r = tmoe.route(torch.softmax((_t(x).reshape(g, -1, 64) @ tp.router), -1),
                   tcfg)
    dropped = (~r.keep_tok).all(-1).reshape(2, 64)
    assert dropped.any()
    assert not got[dropped].any()


# ---------------------------------------------------------------------------
# the model and the serving path
# ---------------------------------------------------------------------------

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


def test_interop_carries_the_moe_keys(pair):
    _, _, tcfg, jparams, model = pair
    flat = _flat(jparams)
    moe_keys = sorted(k for k in flat if "/moe/" in k)
    want = {"router", "wi_gate", "wi_up", "wo"} | (
        {"shared_gate", "shared_up", "shared_down"} if tcfg.shared_expert
        else set())
    assert {k.split("/")[-1] for k in moe_keys} == want
    e, d, f = tcfg.n_experts, tcfg.d_model, tcfg.d_ff
    assert flat["stack/blocks/moe/wi_gate"].shape == (tcfg.n_layers, e, d, f)
    back = interop.arrays_from_lm_params(model)
    assert sorted(back) == sorted(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])
    missing = {k: v for k, v in flat.items() if k != "stack/blocks/moe/wo"}
    with pytest.raises(KeyError):
        interop.lm_params_from_arrays(missing, tcfg, device="cpu")


def test_the_block_specs_hold_moe_not_ffn(pair):
    _, _, tcfg, _, model = pair
    specs = ttf.attn_block_specs(tcfg)
    assert "moe" in specs and "ffn" not in specs
    assert not hasattr(model.stack.blocks[0], "ffn")


def test_forward_and_aux_match_reference(pair):
    arch, jcfg, tcfg, jparams, model = pair
    toks = _prompts(tcfg, seed=15)
    want, aux_w = jmodel.forward(jparams, jnp.asarray(toks), jcfg)
    got, aux = tmodel.forward(model, _t(toks), tcfg)
    _close(got, want, LOGIT_TOL, arch)
    _close(aux, aux_w, AUX_TOL, f"{arch} aux")
    assert float(aux) > 0
    # a ragged length: other groups (t = 74 -> 2 groups) and capacities
    want, aux_w = jmodel.forward(jparams, jnp.asarray(toks[:, :37]), jcfg)
    got, aux = tmodel.forward(model, _t(toks[:, :37]), tcfg)
    _close(got, want, LOGIT_TOL, f"{arch} ragged")
    _close(aux, aux_w, AUX_TOL)


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
        tpq = interop.pq_cache_from_arrays(
            {k: np.asarray(getattr(jpq, k).astype(jnp.float32))
             if "cb" in k else np.asarray(getattr(jpq, k))
             for k in jpq._fields}, device="cpu")
    jl, jc = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                            max_seq=max_seq, pq_cache=jpq)
    tl, tc = tmodel.prefill(model, _t(prompts), tcfg, max_seq=max_seq,
                            pq_cache=tpq)
    _close(tl, jl, LOGIT_TOL, f"{arch} {cache} prefill")
    if pq:
        assert np.mean(tc.k_codes.numpy() != np.asarray(jc.k_codes)) <= 0.01
    else:
        _close(tc.k, jc.k, LOGIT_TOL)
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
    # the first token's logits are the prefill's; the teacher-forced
    # forward groups S + GEN - 1 tokens otherwise (other drops), so the
    # steps after are held by their tokens
    jl, _ = jmodel.prefill(jparams, jnp.asarray(prompts), jcfg,
                           max_seq=PROMPT + GEN)
    _close(logits[:, 0], jl, LOGIT_TOL)
    for r in range(B):
        for i in range(GEN):
            if got[r, i] == want[r, i]:
                continue
            # where the streams part: a near-tie of the port's top two
            top2 = np.sort(logits[r, i, :tcfg.vocab].numpy())[-2:]
            assert top2[1] - top2[0] <= LOGIT_TOL * max(1.0, abs(top2[1])), \
                (arch, r, i)
            break


def test_serve_batch_pq_runs_the_plain_decode_on_the_cpu(pair):
    _, _, tcfg, _, model = pair
    from repro_torch.kernels import pq_decode_kernel as tpqk
    before = tpqk.launches
    stats = {}
    toks = tserve.serve_batch(tcfg.replace(kv_pq=True), model,
                              _t(_prompts(tcfg, seed=18)), GEN, stats=stats)
    assert toks.shape == (B, GEN) and int(toks.max()) < tcfg.vocab
    assert tpqk.launches == before      # the CPU takes the plain version
    assert stats["decode_steps"] == GEN - 1
