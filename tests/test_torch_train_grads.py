"""The port's training gradients held against ``jax.value_and_grad`` of the
reference's ``loss_fn`` on the CPU, for all ten smoke configs, one train
step against the reference's jitted step, remat, and the SSD backward.

Each arch's model is built once a module from the reference's parameters
(``interop``), and both packages see the same ``TokenBatch`` (and, for
internvl2 and musicgen, the same ``frontend_embeds``). Tolerances: the
loss at 1e-5 relative; each gradient leaf within GRAD_TOL[arch] of its
own largest |value|. qwen3 (qk_norm) and rwkv6 (no attention) agree to
~3e-6 and are held at 1e-5; the archs without qk_norm at 2e-4: the
reference's init takes the head count as wq's and wk's fan-in, so their
attention is near one-hot and its softmax backward multiplies the f32
summation-order differences (measured up to 8.4e-5, zamba2's shared
block and nemotron's embedding). The MoE archs' routing is the
reference's (a stable top-k, ``test_torch_moe.py``); a gate within an
ulp of a tie could route a token to another expert and move its
gradients wholesale, which these seeds' gates are far from.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import tokens as jtok
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.train import checkpoint as jck
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.models import layers as tll
from repro_torch.models import model as tmodel
from repro_torch.models import ssm as tssm
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

LOSS_RTOL = 1e-5
SHARP = 2e-4
GRAD_TOL = {"qwen3-1.7b": 1e-5, "rwkv6-3b": 1e-5}
ARCHS = tuple(tconfigs.ALIASES)
B, S = 2, 32
# one train step: the updated parameters within STEP_TOL x lr of the
# reference's (an update is lr * m / (sqrt(v) + eps) + decay: an element
# whose gradient is near zero moves by up to lr either way on an ulp of
# its sign, so the bound is held on all but STEP_OUTLIERS of elements)
STEP_TOL, STEP_OUTLIERS = 1e-3, 1e-3


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(cfg, seed=0):
    b = jtok.batch_at_step(jtok.TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=S, global_batch=B, seed=seed), 0)
    batch = {k: np.array(v) for k, v in b._asdict().items()}
    if cfg.frontend != "none":
        batch["frontend_embeds"] = np.random.default_rng(seed + 1).normal(
            0, 1, (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module", params=ARCHS)
def arch_pair(request):
    arch = request.param
    jcfg = jconfigs.get_smoke_config(arch)
    tcfg = tconfigs.get_smoke_config(arch)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, tcfg, jparams


def _port_grads(model, batch, cfg):
    loss, metrics = tmodel.loss_fn(
        model, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    named = list(model.named_parameters())
    gs = torch.autograd.grad(loss, [p for _, p in named], allow_unused=True)
    return loss, metrics, interop._arrays_from_named(
        (n, torch.zeros_like(p) if g is None else g)
        for (n, p), g in zip(named, gs))


def test_loss_and_every_gradient_leaf_match_the_reference(arch_pair):
    arch, jcfg, tcfg, jparams = arch_pair
    model = tll.set_trainable(interop.lm_params_from_arrays(
        _flat(jparams), tcfg, device="cpu"))
    batch = _batch(jcfg)
    (want_l, want_m), jgrads = jax.value_and_grad(
        lambda p: jmodel.loss_fn(p, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, jcfg),
        has_aux=True)(jparams)
    loss, metrics, got = _port_grads(model, batch, tcfg)
    np.testing.assert_allclose(float(loss.detach()), float(want_l),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["aux"]), float(want_m["aux"]),
                               rtol=LOSS_RTOL, atol=1e-7)
    want = _flat(jgrads)
    assert set(got) == set(want)
    tol = GRAD_TOL.get(arch, SHARP)
    for k, w in want.items():
        assert np.isfinite(got[k]).all(), k
        scale = max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(got[k], w, rtol=0, atol=tol * scale,
                                   err_msg=f"{arch}: {k}")


def test_frontend_embeddings_cut_the_gradient_of_the_tokens_they_replace():
    """With frontend embeddings the embedding rows of the overwritten
    positions' tokens get no gradient from them (the reference's
    dynamic_update_slice)."""
    tcfg = tconfigs.get_smoke_config("internvl2-1b")
    model = tll.set_trainable(tmodel.init_lm(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    batch = _batch(tcfg)
    f = tcfg.frontend_len
    batch["tokens"][:, :f] = 7                  # only in embedded positions
    batch["tokens"][:, f:] = np.where(batch["tokens"][:, f:] == 7, 8,
                                      batch["tokens"][:, f:])
    _, _, got = _port_grads(model, batch, tcfg)
    assert not got["embedding"][7].any()
    assert got["embedding"].any()


@pytest.mark.parametrize("arch,variants", [
    ("qwen3-1.7b", ("none", "layer", "group:2")),
    ("zamba2-2.7b", ("none", "layer")),
    ("rwkv6-3b", ("none", "layer", "group:2")),
    ("dbrx-132b", ("none", "layer", "group:2")),
])
def test_remat_gives_the_same_gradients_bit_for_bit(arch, variants):
    """Each remat unit recomputed in backward changes no bit of the loss
    or the gradients (4-layer configs, two groups of two)."""
    base = tconfigs.get_smoke_config(arch).replace(n_layers=4)
    model = tll.set_trainable(tmodel.init_lm(
        base, generator=torch.Generator().manual_seed(0), device="cpu"))
    batch = _batch(base)
    out = {r: _port_grads(model, batch, base.replace(remat=r))
           for r in variants}
    ref_loss, _, ref_g = out["none"]
    for r in variants[1:]:
        loss, _, g = out[r]
        assert torch.equal(loss, ref_loss), r
        for k in ref_g:
            np.testing.assert_array_equal(g[k], ref_g[k], err_msg=f"{r}: {k}")


def test_remat_checkpoints_only_while_autograd_records():
    cfg = tconfigs.get_smoke_config("qwen3-1.7b").replace(n_layers=4,
                                                          remat="group:2")
    model = tmodel.init_lm(cfg, generator=torch.Generator().manual_seed(0),
                           device="cpu")
    tokens = torch.from_numpy(_batch(cfg)["tokens"])
    calls = []
    orig = tll.checkpoint
    try:
        tll.checkpoint = lambda fn, *a, **k: calls.append(1) or orig(
            fn, *a, **k)
        tmodel.forward(model, tokens, cfg)           # inference mode
        assert not calls
        tll.set_trainable(model)
        tmodel.loss_fn(model, {k: torch.from_numpy(v) for k, v in
                               _batch(cfg).items()}, cfg)
        assert len(calls) == 2                       # two groups of two
    finally:
        tll.checkpoint = orig


def test_one_train_step_matches_the_reference_jitted_step():
    jcfg = jconfigs.get_smoke_config("qwen3-1.7b")
    tcfg = tconfigs.get_smoke_config("qwen3-1.7b")
    ocfg = dict(lr=1e-3, warmup_steps=0, total_steps=10)
    params = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    jstate = jloop.TrainState(params, jopt.init_state(params))
    state = interop.train_state_from_arrays(jck._flatten_with_names(jstate),
                                            tcfg, device="cpu")
    batch = _batch(jcfg)
    jstep = jax.jit(jloop.make_train_step(jcfg, jopt.AdamWConfig(**ocfg), 2))
    jnew, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = tloop.make_train_step(tcfg, topt.AdamWConfig(**ocfg), 2)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    want = jck._flatten_with_names(jnew)
    got = interop.arrays_from_train_state(new)
    assert int(got[".opt/.step"]) == int(want[".opt/.step"]) == 1
    lr = ocfg["lr"]
    for k, w in want.items():
        if k.startswith(".params/"):
            far = np.abs(got[k] - w) > STEP_TOL * lr
            assert far.mean() <= STEP_OUTLIERS, (k, far.sum())
            assert np.abs(got[k] - w).max() <= 2.5 * lr, k
        elif k != ".opt/.step":
            scale = np.abs(w).max()
            np.testing.assert_allclose(got[k], w, rtol=0, err_msg=k,
                                       atol=SHARP * scale)


def _ssd_grads(log_a_scale, seed=0):
    rng = np.random.default_rng(seed)
    b, s, nh, hd, g, ds, chunk = 1, 32, 2, 4, 1, 4, 16
    xh = rng.standard_normal((b, s, nh, hd)).astype(np.float32)
    bm = rng.standard_normal((b, s, g, ds)).astype(np.float32)
    cm = rng.standard_normal((b, s, g, ds)).astype(np.float32)
    la = (-log_a_scale * rng.random((b, s, nh))).astype(np.float32)
    want = jax.grad(lambda x, a: jnp.sum(jssm.ssd_chunked(
        x, a, bm, cm, chunk)[0] ** 2), argnums=(0, 1))(xh, la)
    tx = torch.tensor(xh, requires_grad=True)
    ta = torch.tensor(la, requires_grad=True)
    y, _ = tssm.ssd_chunked(tx, ta, torch.from_numpy(bm),
                            torch.from_numpy(cm), chunk)
    (y ** 2).sum().backward()
    return [np.asarray(w) for w in want], [tx.grad.numpy(), ta.grad.numpy()]


def test_ssd_backward_is_finite_where_the_reference_is_nan():
    """Reference defect (ROADMAP Queue 3): the reference exponentiates the
    intra-chunk decay's upper entries and masks the product, so where one
    overflows (a chunk's decay past e^88) its gradient is 0 x inf = NaN.
    The port masks before the exponential: the same gradients where the
    reference's are finite, finite where they are not."""
    want, got = _ssd_grads(0.5)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=1e-5 * np.abs(w).max())
    want, got = _ssd_grads(20.0)       # decays of up to e^-160 a chunk
    assert np.isnan(want[1]).any()
    assert all(np.isfinite(g).all() for g in got)
    np.testing.assert_allclose(got[0], want[0], rtol=0,
                               atol=1e-5 * np.abs(want[0]).max())
