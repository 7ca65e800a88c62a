"""The port's training substrate (``repro_torch.data.tokens``, the loss in
``models.model``, ``train.optimizer``, ``train.checkpoint``,
``train.grad_compress``, ``train.train_loop``) held against the JAX
reference on the CPU.

Tolerances: token batches, checkpoint bytes and names, the restart, the
codec's packing and decoding and its error-feedback arithmetic bit for
bit; the loss at 1e-5 relative (f32 sums in another order); AdamW's
parameters at 1e-6 (f32: the global norm summed over per-layer leaves
where the reference sums stacked ones, and ``pow`` for the bias
corrections, each an ulp apart; the update m / sqrt(v) is scale-free, so
they move the parameters by ~1e-7 of lr) and within one bf16 unit in the
last place for bf16 parameters (a rounding of p - lr * delta can fall
either side), the moments within 1e-5 of each leaf's largest |value|
(random gradients cancel in mu over steps); microbatches 2 against 1 at
the reference's own 2e-5. The codec's k-means draws from a
``torch.Generator`` where the reference draws from ``jax.random``, so its
reconstruction error is held within CODEC_FACTOR of the reference's on
the same gradient, not in bits.
"""
import json
import os
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import tokens as jtok
from repro.models import model as jmodel
from repro.train import checkpoint as jck
from repro.train import grad_compress as jgc
from repro.train import optimizer as jopt
from repro.train import train_loop as jloop
from repro_torch import configs as tconfigs
from repro_torch import interop
from repro_torch.data import tokens as ttok
from repro_torch.models import layers as tll
from repro_torch.models import model as tmodel
from repro_torch.train import checkpoint as tck
from repro_torch.train import grad_compress as tgc
from repro_torch.train import optimizer as topt
from repro_torch.train import train_loop as tloop

LOSS_RTOL = 1e-5
PARAM_TOL = 1e-6
MOMENT_RTOL = 1e-5
MICRO_ATOL = 2e-5
CODEC_FACTOR = 1.25
ARCH = "qwen3-1.7b"
# the reference's TrainState of qwen3-smoke flattens to 43 names: 14
# parameters (3 + 11 stacked) under .params, .opt/.mu and .opt/.nu, and
# .opt/.step
QWEN3_SMOKE_NAMES = 43


def _cfgs(arch=ARCH, **kw):
    return (jconfigs.get_smoke_config(arch).replace(**kw),
            tconfigs.get_smoke_config(arch).replace(**kw))


def _jstate(jcfg, seed=0):
    params = jmodel.init_lm(jax.random.PRNGKey(seed), jcfg)
    return jloop.TrainState(params, jopt.init_state(params))


def _tstate(jstate, tcfg):
    """The reference's state carried into the port, by its checkpoint
    names."""
    return interop.train_state_from_arrays(jck._flatten_with_names(jstate),
                                           tcfg, device="cpu")


def _per_layer(flat: dict, model) -> dict:
    """Stacked path-key arrays -> tensors keyed by the model's dotted
    parameter names."""
    out = {}
    for name, _ in model.named_parameters():
        key, layer = tll.tree_key(name)
        a = np.asarray(flat[key], np.float32)
        out[name] = torch.from_numpy(np.array(a[layer] if layer is not None
                                              else a))
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _batch(cfg, b=2, s=32, step=0, device="cpu"):
    pc = ttok.TokenPipelineConfig(vocab=cfg.vocab, seq_len=s, global_batch=b)
    return dict(ttok.batch_at_step(pc, step, device)._asdict())


def _jbatch(batch):
    return {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


# ---------------------------------------------------------------------------
# tokens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1)])
@pytest.mark.parametrize("step", [0, 1, 7])
def test_token_batches_equal_the_reference_bit_for_bit(step, hosts):
    count, host = hosts
    kw = dict(vocab=1000, seq_len=64, global_batch=4, host_count=count,
              host_id=host, seed=3)
    want = jtok.batch_at_step(jtok.TokenPipelineConfig(**kw), step)
    got = ttok.batch_at_step(ttok.TokenPipelineConfig(**kw), step, "cpu")
    np.testing.assert_array_equal(
        ttok._host_batch(ttok.TokenPipelineConfig(**kw), step),
        jtok._host_batch(jtok.TokenPipelineConfig(**kw), step))
    for f in ("tokens", "targets", "mask"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == {"mask": torch.float32}.get(f, torch.int32)
        np.testing.assert_array_equal(g.numpy(), w)


def test_prefetch_iterator_yields_the_pipeline_in_order():
    cfg = ttok.TokenPipelineConfig(vocab=100, seq_len=16, global_batch=2)
    it = ttok.PrefetchIterator(cfg, start_step=5, device="cpu")
    try:
        for want_step in (5, 6, 7):
            step, batch = next(it)
            assert step == want_step
            assert torch.equal(batch.tokens,
                               ttok.batch_at_step(cfg, step, "cpu").tokens)
    finally:
        it.close()
    assert not it._thread.is_alive()


def test_batch_at_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = ttok.TokenPipelineConfig(vocab=100, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttok.batch_at_step(cfg, 0)


# ---------------------------------------------------------------------------
# the loss
# ---------------------------------------------------------------------------

def test_ce_from_logits_masks_the_padded_vocab():
    jcfg, tcfg = _cfgs(vocab=250)                 # padded to 256
    assert tcfg.padded_vocab == 256
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (2, 5, 256)).astype(np.float32)
    logits[..., 250:] = 50.0                      # would dominate unmasked
    targets = rng.integers(0, 250, (2, 5)).astype(np.int32)
    mask = (rng.random((2, 5)) < 0.7).astype(np.float32)
    want = jmodel._ce_from_logits(jnp.asarray(logits), jnp.asarray(targets),
                                  jnp.asarray(mask), jcfg)
    got = tmodel._ce_from_logits(torch.from_numpy(logits),
                                 torch.from_numpy(targets),
                                 torch.from_numpy(mask), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=LOSS_RTOL)
    # bf16 logits are summed in f32
    got16 = tmodel._ce_from_logits(torch.from_numpy(logits).bfloat16(),
                                   torch.from_numpy(targets),
                                   torch.from_numpy(mask), tcfg)
    want16 = jmodel._ce_from_logits(jnp.asarray(logits, jnp.bfloat16),
                                    jnp.asarray(targets), jnp.asarray(mask),
                                    jcfg)
    np.testing.assert_allclose(float(got16), float(want16), rtol=LOSS_RTOL)


# loss_chunk 0 (off), 32 (= S: the full path by s <= chunk), 12 (does not
# divide S: full), 8 and 16 (the chunked path)
@pytest.mark.parametrize("chunk", [0, 32, 12, 8, 16])
def test_loss_fn_matches_the_reference_on_both_paths(chunk):
    jcfg, tcfg = _cfgs(loss_chunk=chunk)
    jparams = jmodel.init_lm(jax.random.PRNGKey(0), jcfg)
    model = interop.lm_params_from_arrays(_flat(jparams), tcfg, device="cpu")
    batch = _batch(tcfg)
    batch["mask"][0, :5] = 0.0
    want_l, want_m = jmodel.loss_fn(jparams, _jbatch(batch), jcfg)
    got_l, got_m = tmodel.loss_fn(model, batch, tcfg)
    np.testing.assert_allclose(float(got_l), float(want_l), rtol=LOSS_RTOL)
    for k in ("ce", "aux", "tokens"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=LOSS_RTOL, atol=1e-7)
    assert float(got_m["tokens"]) == 2 * 32 - 5


def test_chunked_and_full_loss_give_the_same_gradients():
    """The chunked path (each chunk checkpointed) against the full path of
    the port, within f32 summation order."""
    _, tcfg = _cfgs()
    model = tll.set_trainable(tmodel.init_lm(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    batch = _batch(tcfg)
    grads = []
    for chunk in (0, 8):
        loss, _ = tmodel.loss_fn(model, batch, tcfg.replace(loss_chunk=chunk))
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_serving_entry_points_stay_in_inference_mode():
    _, tcfg = _cfgs()
    model = tll.set_trainable(tmodel.init_lm(
        tcfg, generator=torch.Generator().manual_seed(0), device="cpu"))
    logits, _ = tmodel.forward(model, _batch(tcfg)["tokens"], tcfg)
    assert logits.is_inference() and not logits.requires_grad
    tll.set_trainable(model, False)
    assert not any(p.requires_grad for p in model.parameters())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("step", [0, 1, 5, 10, 55, 100, 150])
def test_schedule_matches_the_reference(step):
    cfg = dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    want = jopt.schedule(jopt.AdamWConfig(**cfg), jnp.int32(step))
    got = topt.schedule(topt.AdamWConfig(**cfg),
                        torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("steps", [1, 3])
def test_apply_updates_matches_the_reference(steps, dtype):
    jcfg, tcfg = _cfgs(dtype=dtype)
    jstate = _jstate(jcfg)
    state = _tstate(jstate, tcfg)
    ocfg = dict(lr=1e-2, warmup_steps=1, total_steps=10, clip_norm=1.0)
    jparams, jst = jstate.params, jstate.opt
    params, st = state.params, state.opt
    rng = np.random.default_rng(1)
    for _ in range(steps):
        flat = {k: rng.normal(0, 0.5, v.shape).astype(np.float32)
                for k, v in _flat(jparams).items()}
        jgrads = jax.tree.map(lambda p, k: jnp.asarray(flat[k], p.dtype),
                              jparams, _keys(jparams))
        tgrads = {n: g.to(tmodel.DTYPES[dtype])
                  for n, g in _per_layer(flat, params).items()}
        # the clipping is active: the norm is well over clip_norm (its f32
        # sums of squares run over other leaves, in another order)
        np.testing.assert_allclose(float(topt.global_norm(tgrads)),
                                   float(jopt.global_norm(jgrads)),
                                   rtol=MOMENT_RTOL)
        assert float(topt.global_norm(tgrads)) > 10
        jparams, jst, jm = jopt.apply_updates(jparams, jgrads, jst,
                                              jopt.AdamWConfig(**ocfg))
        params, st, m = topt.apply_updates(params, tgrads, st,
                                           topt.AdamWConfig(**ocfg))
        np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
    assert int(st.step) == int(jst.step) == steps
    got = interop.arrays_from_lm_params(params)
    for k, want in _flat(jparams).items():
        want = np.asarray(want, np.float32)
        if dtype == "float32":
            np.testing.assert_allclose(got[k], want, rtol=PARAM_TOL,
                                       atol=PARAM_TOL, err_msg=k)
        else:   # one bf16 unit in the last place at most
            ulp = np.abs(want) * 2.0 ** -7 + 1e-30
            assert np.all(np.abs(got[k] - want) <= ulp), k
    for tree, jtree in ((st.mu, jst.mu), (st.nu, jst.nu)):
        got = interop._arrays_from_named(tree.items())
        for k, want in _flat(jtree).items():
            np.testing.assert_allclose(got[k], want, rtol=0, err_msg=k,
                                       atol=MOMENT_RTOL * np.abs(want).max())


def _keys(tree, prefix=""):
    """A tree of the same structure whose leaves are their path keys."""
    return {k: (_keys(v, f"{prefix}{k}/") if isinstance(v, dict)
                else f"{prefix}{k}") for k, v in tree.items()}


def test_adamw_reduces_a_quadratic_and_clips():
    """The reference's two optimizer tests, on the port."""
    model = tll.Params({"w": tll.ParamSpec((2,))}, dtype=torch.float32,
                       device=torch.device("cpu"))
    with torch.no_grad():
        model.w.copy_(torch.tensor([3.0, -2.0]))
    cfg = topt.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=100,
                           weight_decay=0.0)
    state = topt.init_state(model)
    for _ in range(60):
        model, state, m = topt.apply_updates(model, {"w": 2 * model.w},
                                             state, cfg)
    assert float(model.w.abs().max()) < 0.5 and float(m["lr"]) > 0
    _, _, m = topt.apply_updates(model, {"w": torch.full((2,), 100.0)},
                                 topt.init_state(model),
                                 topt.AdamWConfig(lr=1e-3, warmup_steps=0))
    assert float(m["grad_norm"]) == pytest.approx(100.0 * 2 ** 0.5)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _manifest(d, step):
    with open(os.path.join(d, f"step_{step:08d}", tck.MANIFEST)) as f:
        return json.load(f)


def _members(d, step):
    with zipfile.ZipFile(os.path.join(d, f"step_{step:08d}",
                                      "shard_00000.npz")) as z:
        return {n: z.read(n) for n in z.namelist()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_format_equals_the_reference(tmp_path, dtype):
    """Names, shapes, dtypes and every array's .npy bytes equal the
    reference's for a smoke TrainState (bf16 as '<V2' void)."""
    jcfg, tcfg = _cfgs(dtype=dtype)
    jstate = _jstate(jcfg)
    state = _tstate(jstate, tcfg)
    jck.save(str(tmp_path / "j"), 3, jstate)
    tck.save(str(tmp_path / "t"), 3, state)
    want, got = _manifest(tmp_path / "j", 3), _manifest(tmp_path / "t", 3)
    assert got == want
    assert list(got["shapes"]) == list(want["shapes"])   # flattening order
    assert len(got["names"]) == QWEN3_SMOKE_NAMES
    assert ".params/embedding" in got["names"]
    assert got["shapes"][".params/stack/blocks/attn/wq"][0] == tcfg.n_layers
    assert got["dtypes"][".opt/.step"] == "int32"
    assert got["shapes"][".opt/.step"] == []
    assert got["dtypes"][".params/embedding"] == dtype
    assert _members(tmp_path / "t", 3) == _members(tmp_path / "j", 3)


def test_f32_checkpoints_cross_open_both_ways(tmp_path):
    jcfg, tcfg = _cfgs()
    jstate = _jstate(jcfg)
    # move the state off its init: one reference step with random grads
    rng = np.random.default_rng(2)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, 1, p.shape).astype(np.float32)), jstate.params)
    p, o, _ = jopt.apply_updates(jstate.params, grads, jstate.opt,
                                 jopt.AdamWConfig(warmup_steps=0))
    jstate = jloop.TrainState(p, o)
    want = jck._flatten_with_names(jstate)
    # the reference's checkpoint into a port state of other values
    jck.save(str(tmp_path / "j"), 1, jstate)
    fresh = tloop.init_train_state(tcfg, 5, torch.device("cpu"))
    step, fresh = tck.restore(str(tmp_path / "j"), fresh)
    assert step == 1
    got = interop.arrays_from_train_state(fresh)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # the port's checkpoint into the reference
    tck.save(str(tmp_path / "t"), 1, fresh)
    like = _jstate(jcfg, seed=9)
    step, back = jck.restore(str(tmp_path / "t"), like)
    assert step == 1
    for k, v in jck._flatten_with_names(back).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_a_reference_bf16_checkpoint_restores_in_the_port(tmp_path):
    jcfg, tcfg = _cfgs(dtype="bfloat16")
    jstate = _jstate(jcfg)
    want = jck._flatten_with_names(jstate)
    jck.save(str(tmp_path), 2, jstate)
    fresh = tloop.init_train_state(tcfg, 5, torch.device("cpu"))
    assert fresh.params.embedding.dtype == torch.bfloat16
    tck.restore(str(tmp_path), fresh)
    for name, p in fresh.params.named_parameters():
        key, layer = tll.tree_key(name)
        w = _bits(want[".params/" + key])
        w = w[layer] if layer is not None else w
        np.testing.assert_array_equal(p.detach().view(torch.int16).numpy()
                                      .view(np.uint16), w, err_msg=name)
    got = interop.arrays_from_train_state(fresh)
    for k in want:
        if not k.startswith(".params/"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_the_reference_cannot_restore_a_bf16_checkpoint(tmp_path):
    """Reference defect (ROADMAP Queue 3): ``np.savez`` stores an
    ml_dtypes bfloat16 as raw 2-byte void, which the reference's restore
    cannot cast back. The port reads the bits, guided by the manifest."""
    state = {"w": jnp.arange(4, dtype=jnp.bfloat16)}
    jck.save(str(tmp_path), 1, state)
    with np.load(tmp_path / "step_00000001" / "shard_00000.npz") as z:
        assert z["w"].dtype == np.dtype("V2")
    with pytest.raises(ValueError, match="No cast function available"):
        jck.restore(str(tmp_path), state)
    like = {"w": torch.zeros(4, dtype=torch.bfloat16)}
    _, got = tck.restore(str(tmp_path), like)
    assert got["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


def test_checkpoint_keep_k_latest_and_stale_tmp(tmp_path):
    """keep-k, stale tmp directories and latest_step as the reference
    keeps them: a step directory without a manifest counts for keep-k
    (it sorts last here) but is never the latest."""
    assert tck.latest_step(str(tmp_path / "none")) is None
    listing = {}
    for pkg, save in (("j", jck.save), ("t", tck.save)):
        d = str(tmp_path / pkg)
        os.makedirs(os.path.join(d, ".tmp_step_9_crashed"))
        os.makedirs(os.path.join(d, "step_00000099"))     # no manifest
        for s in range(6):
            x = float(s)
            save(d, s, {"x": jnp.full((1,), x) if pkg == "j"
                        else torch.full((1,), x)}, keep=2)
        listing[pkg] = sorted(os.listdir(d))
    assert listing["t"] == listing["j"] == ["step_00000005", "step_00000099"]
    d = str(tmp_path / "t")
    assert tck.latest_step(d) == jck.latest_step(str(tmp_path / "j")) == 5
    step, got = tck.restore(d, {"x": torch.zeros(1)})
    assert step == 5 and float(got["x"]) == 5.0
    tck.save(d, 7, {"x": torch.full((1,), 7.0)}, keep=0)    # keep all
    step, got = tck.restore(d, {"x": torch.zeros(1)}, step=5)
    assert step == 5 and float(got["x"]) == 5.0


def test_checkpoint_restore_errors(tmp_path):
    d = str(tmp_path)
    with pytest.raises(FileNotFoundError):
        tck.restore(d, {"x": torch.zeros(1)})
    tck.save(d, 1, {"x": torch.zeros(2), "y": torch.zeros(3)})
    with pytest.raises(KeyError, match="'z' not in checkpoint"):
        tck.restore(d, {"x": torch.zeros(2), "z": torch.zeros(1)})
    like = {"x": torch.ones(2), "y": torch.ones(4)}
    with pytest.raises(ValueError, match="y: checkpoint shape"):
        tck.restore(d, like)
    assert float(like["x"].sum()) == 2.0      # nothing written on failure
    manifest = _manifest(d, 1)
    manifest["names"].append("w")
    with open(os.path.join(d, "step_00000001", tck.MANIFEST), "w") as f:
        json.dump(manifest, f)
    with pytest.raises(ValueError, match="missing arrays: \\['w'\\]"):
        tck.restore(d, {"x": torch.zeros(2)})


def test_checkpoint_detects_a_damaged_array(tmp_path):
    d = str(tmp_path)
    tck.save(d, 1, {"x": torch.arange(1000, dtype=torch.float32)})
    path = os.path.join(d, "step_00000001", "shard_00000.npz")
    raw = bytearray(open(path, "rb").read())
    at = raw.find(np.arange(1000, dtype=np.float32)[500:502].tobytes())
    raw[at] ^= 0xFF
    with open(path, "wb") as f:
        f.write(raw)
    with pytest.raises(zipfile.BadZipFile):
        tck.restore(d, {"x": torch.zeros(1000)})


def test_async_checkpointer_snapshots_and_surfaces_errors(tmp_path):
    ck = tck.AsyncCheckpointer(str(tmp_path), keep=3)
    x = {"x": torch.zeros(3)}
    ck.save(1, x)
    x["x"].add_(5.0)                         # after the snapshot
    ck.wait()
    _, got = tck.restore(str(tmp_path), {"x": torch.ones(3)})
    assert got["x"].tolist() == [0.0, 0.0, 0.0]
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = tck.AsyncCheckpointer(str(blocker))
    bad.save(1, x)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                                # the error is raised once


# ---------------------------------------------------------------------------
# the train loop
# ---------------------------------------------------------------------------

def test_restart_is_bit_for_bit(tmp_path):
    """Interrupt -> restart -> the final state and the resumed steps'
    metrics equal an uninterrupted run's."""
    _, tcfg = _cfgs()
    kw = dict(steps=6, global_batch=2, seq_len=32, ckpt_every=3,
              log=lambda s: None, device="cpu")
    full, hist = tloop.train(tcfg, ckpt_dir=str(tmp_path / "a"), **kw)
    tloop.train(tcfg, ckpt_dir=str(tmp_path / "b"), **dict(kw, steps=3))
    logs = []
    resumed, hist2 = tloop.train(tcfg, ckpt_dir=str(tmp_path / "b"),
                                 **dict(kw, log=logs.append))
    assert "[train] resumed from step 3" in logs
    assert [h["loss"] for h in hist2] == [h["loss"] for h in hist[3:]]
    a = interop.arrays_from_train_state(full)
    b = interop.arrays_from_train_state(resumed)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert tck.latest_step(str(tmp_path / "b")) == 6
    assert set(hist[0]) == {"ce", "aux", "tokens", "grad_norm", "lr",
                            "loss", "step", "dt"}


def test_microbatches_match_the_full_batch():
    _, tcfg = _cfgs()
    ocfg = topt.AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    batch = _batch(tcfg, b=4)
    out = []
    for mb in (1, 2):
        state = tloop.init_train_state(tcfg, 0, torch.device("cpu"))
        out.append(tloop.make_train_step(tcfg, ocfg, mb)(state, batch))
    (s1, m1), (s2, m2) = out
    assert float(m2["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    for a, b in zip(s1.params.parameters(), s2.params.parameters()):
        torch.testing.assert_close(a, b, atol=MICRO_ATOL, rtol=0)


def test_accumulated_gradients_are_the_f32_mean():
    _, tcfg = _cfgs(dtype="bfloat16")
    state = tloop.init_train_state(tcfg, 0, torch.device("cpu"))
    batch = _batch(tcfg, b=4)
    g1, _, _ = tloop.accumulate_grads(state.params, batch, tcfg, 1)
    g2, loss, _ = tloop.accumulate_grads(state.params, batch, tcfg, 2)
    assert all(g.dtype == torch.bfloat16 for g in g1.values())
    halves = [tloop.accumulate_grads(
        state.params, {k: v[i:i + 2] for k, v in batch.items()}, tcfg, 1)
        for i in (0, 2)]
    for n, g in g2.items():
        assert g.dtype == torch.float32
        want = halves[0][0][n].float() / 2 + halves[1][0][n].float() / 2
        assert torch.equal(g, want), n
    assert torch.equal(loss, halves[0][1] / 2 + halves[1][1] / 2)


def test_straggler_watchdog():
    events = []
    w = tloop.StragglerWatchdog(factor=2.0,
                                on_straggler=lambda *a: events.append(a))
    for s in range(5):
        w.observe(s, 1.0)
    assert not events
    assert w.observe(5, 5.0)
    assert events and events[0][0] == 5
    assert w.ema == pytest.approx(1.0)     # not poisoned by the outlier


def test_grad_compress_keeps_a_zero_error_state_in_both(tmp_path):
    """Reference defect mirrored (ROADMAP Queue 3): ``train(grad_compress=
    True)`` creates and checkpoints the error state and never compresses,
    so it stays zero in both packages."""
    jcfg, tcfg = _cfgs()
    kw = dict(steps=2, global_batch=2, seq_len=16, grad_compress=True,
              log=lambda s: None)
    jstate, _ = jloop.train(jcfg, **kw)
    tstate, _ = tloop.train(tcfg, ckpt_dir=str(tmp_path), ckpt_every=2,
                            device="cpu", **kw)
    assert all(not np.any(np.asarray(e)) for e in
               jax.tree.leaves(jstate.ef_error))
    assert tstate.ef_error is not None
    assert all(not e.any() for e in tstate.ef_error.values())
    names = _manifest(tmp_path, 2)["names"]
    assert ".ef_error/embedding" in names
    assert len(names) == QWEN3_SMOKE_NAMES + 14


# ---------------------------------------------------------------------------
# the PQ gradient codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 8), (64,), (7, 5), (3,)])
def test_decompress_equals_the_reference_on_its_own_codes(shape):
    g = jax.random.normal(jax.random.PRNGKey(1), shape)
    if int(np.prod(shape)) < 64:      # the reference's k-means needs k rows
        c = jgc.CompressedGrad(
            jnp.asarray(np.random.default_rng(0).integers(
                0, 256, (-(-int(np.prod(shape)) // 8),), dtype=np.uint8)),
            jax.random.normal(jax.random.PRNGKey(2), (16, 4)), shape,
            -(-int(np.prod(shape)) // 4))
    else:
        c = jgc.compress(jax.random.PRNGKey(0), g, jgc.PQGradCodec())
    tc = tgc.CompressedGrad(torch.from_numpy(np.array(c.codes)),
                            torch.from_numpy(np.array(c.codebook)),
                            c.shape, c.nrows)
    np.testing.assert_array_equal(tgc.decompress(tc).numpy(),
                                  np.asarray(jgc.decompress(c)))
    assert tgc.compressed_bytes(tc) == jgc.compressed_bytes(c)


@pytest.mark.parametrize("shape", [(256, 8), (64,), (9, 7)])
def test_compress_packs_the_nearest_codeword(shape):
    g = torch.from_numpy(np.random.default_rng(3).normal(
        0, 1, shape).astype(np.float32))
    c = tgc.compress(torch.Generator().manual_seed(0), g, tgc.PQGradCodec())
    rows = tgc._rows(g, 4)
    want = torch.argmin(torch.cdist(rows, c.codebook), dim=-1)
    lo, hi = c.codes & 0xF, c.codes >> 4
    codes = torch.stack([lo, hi], -1).reshape(-1)[:c.nrows].long()
    d = ((rows - c.codebook[codes]) ** 2).sum(-1)
    best = ((rows - c.codebook[want]) ** 2).sum(-1)
    torch.testing.assert_close(d, best, rtol=1e-5, atol=1e-6)
    assert c.codes.numel() == -(-c.nrows // 2) and c.nrows == rows.shape[0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_codec_error_is_within_a_factor_of_the_reference(seed):
    rng = np.random.default_rng(seed)
    grads = {"w": rng.normal(0, 1, (256, 8)).astype(np.float32),
             "b": rng.standard_t(3, (512,)).astype(np.float32)}
    jdec, _, jst = jgc.ef_step(jax.random.PRNGKey(seed),
                               {k: jnp.asarray(v) for k, v in grads.items()},
                               jgc.init_error(grads), jgc.PQGradCodec())
    tg = {k: torch.from_numpy(v) for k, v in grads.items()}
    tdec, _, tst = tgc.ef_step(torch.Generator().manual_seed(seed), tg,
                               tgc.init_error(tg), tgc.PQGradCodec())
    assert tst == jst                 # bytes and ratio
    assert tst["ratio"] > 4.0
    for k, g in grads.items():
        want = np.linalg.norm(np.asarray(jdec[k]) - g) / np.linalg.norm(g)
        got = float(torch.linalg.vector_norm(tdec[k] - tg[k])
                    / torch.linalg.vector_norm(tg[k]))
        assert got < CODEC_FACTOR * want, (k, got, want)


def test_ef_step_carries_the_exact_residual():
    rng = np.random.default_rng(4)
    grads = {"w": torch.from_numpy(rng.normal(0, 1, (64, 8)).astype(
        np.float32)).bfloat16()}
    error = {"w": torch.from_numpy(rng.normal(0, 0.1, (64, 8)).astype(
        np.float32))}
    dec, new_err, _ = tgc.ef_step(torch.Generator().manual_seed(0), grads,
                                  error, tgc.PQGradCodec())
    assert dec["w"].dtype == torch.bfloat16 and new_err["w"].dtype == \
        torch.float32
    target = grads["w"].float() + error["w"]
    c = tgc.compress(torch.Generator().manual_seed(0), target,
                     tgc.PQGradCodec())
    dec32 = tgc.decompress(c)
    assert torch.equal(new_err["w"], target - dec32)
    assert torch.equal(dec["w"], dec32.bfloat16())


def test_error_feedback_converges_on_a_quadratic():
    """SGD on EF-compressed gradients still converges (the reference's
    test, on the port)."""
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(32, 4)).astype(np.float32))
    err = tgc.init_error({"w": w})
    codec = tgc.PQGradCodec(dsub=4, sample=128)
    gen = torch.Generator().manual_seed(0)
    params = {"w": w}
    for _ in range(40):
        dec, err, _ = tgc.ef_step(gen, {"w": 2 * params["w"]}, err, codec)
        params = {"w": params["w"] - 0.1 * dec["w"]}
    assert float(torch.linalg.vector_norm(params["w"])) < \
        0.2 * float(torch.linalg.vector_norm(w))
