"""K8's split-and-combine order, in plain PyTorch, held against the JAX
reference on the CPU.

The CUDA kernel (``csrc/pq_decode_attention.cu``) splits the cache into
``pqk.SPLIT``-position splits, takes each split's max, sum and value sum,
and combines the live splits in a second pass. ``pq_decode_plain(...,
split=S)`` computes the same order; here it runs at small shapes (the
LM tests' ``_pq_inputs`` widths: B 2, Smax 32, KV 2, g 2, M 8, head_dim
16) with S = 8 (Smax a multiple) and S = 12 (a ragged last split), at
positions -1, 0, at a split's boundary (S - 1, S, S + 1), at and past
Smax - 1, and with every split but the first dead; for the q8 and the f32
LUT and for f32 and bf16 codebooks.

Tolerances, of each (batch row, head)'s largest |value| (a row with
nothing live is 0 in every version, exactly):
- against ``repro.models.kvcache.pq_decode_attention`` (chunks of 8): in
  f32 1e-4, as the LM tests hold the reference-order version (the LUT is
  built by each framework, a float stage); with bf16 codebooks 2**-6, the
  kernel's own tolerance on the card (the reference rounds each chunk's
  value sum to bf16 and this order does not; p is rounded to bf16 at
  another max; the output is rounded once);
- against the reference-order twin on the same table: in f32 1e-5 (the
  same terms, scaled at other maxima and summed in another order); with
  bf16 codebooks 2**-6, as above.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import kvcache as jkvc
from repro_torch.kernels import pq_decode_kernel as pqk
from repro_torch.models import kvcache as tkvc

B, SMAX, KV, G, M, DSUB = 2, 32, 2, 2, 8, 2
HD = M * DSUB
CHUNK = 8                     # the reference's chunk (a divisor of Smax)
F32_TOL_REF, F32_TOL_TWIN, BF16_TOL = 1e-4, 1e-5, 2.0 ** -6
# (positions, split)
CASES = [([-1, 0], 8),        # nothing live; position 0
         ([7, 8], 8),         # S - 1, S
         ([9, 31], 8),        # S + 1, Smax - 1
         ([32, 40], 8),       # at and past Smax
         ([11, 12], 12),      # Smax not a multiple of S: S - 1, S
         ([13, 31], 12),      # S + 1; the ragged last split live
         ([3, 11], 12),       # every split but the first dead
         ([-1, 100], 12)]


def _inputs(seed, cb_dtype):
    rng = np.random.default_rng(seed)
    return dict(
        q=rng.normal(0, 1, (B, KV * G, HD)).astype(np.float32),
        k_codes=rng.integers(0, 256, (B, SMAX, KV, M // 2), dtype=np.uint8),
        v_codes=rng.integers(0, 256, (B, SMAX, KV, M // 2), dtype=np.uint8),
        k_cb=rng.normal(0, 1, (KV, M, 16, DSUB)).astype(np.float32),
        v_cb=rng.normal(0, 1, (KV, M, 16, DSUB)).astype(np.float32),
        cb_dtype=cb_dtype)


def _torch_args(inp, positions, q8):
    """The kernel's arguments as ``kvcache.pq_decode_attention``'s glue
    makes them."""
    dt = getattr(torch, inp["cb_dtype"])
    k_cb = torch.from_numpy(inp["k_cb"]).to(dt)
    v_cb = torch.from_numpy(inp["v_cb"]).to(dt)
    q = torch.from_numpy(inp["q"])
    lut = tkvc._build_ip_lut(q.reshape(B, KV, G, HD), k_cb) / np.sqrt(HD)
    table, scale, bias = (tkvc._quantize(lut) if q8
                          else (lut.contiguous(), None, None))
    return (table, scale, bias, torch.from_numpy(inp["k_codes"]),
            torch.from_numpy(inp["v_codes"]), v_cb,
            torch.tensor(positions, dtype=torch.int32))


def _rel(got, want):
    """Largest |difference| relative to its row's largest |value|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want).max(-1, keepdims=True), 1e-30)
    return float((np.abs(got - want) / scale).max())


@pytest.mark.parametrize("cb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_split_order_matches_the_reference(case, q8, cb_dtype):
    positions, split = case
    inp = _inputs(27, cb_dtype)
    got = pqk.pq_decode_plain(*_torch_args(inp, positions, q8),
                              chunk=CHUNK, out_dtype=torch.float32,
                              split=split)
    jcb = {k: jnp.asarray(inp[k]).astype(cb_dtype) for k in ("k_cb", "v_cb")}
    want = np.asarray(jkvc.pq_decode_attention(
        jnp.asarray(inp["q"]), jnp.asarray(inp["k_codes"]),
        jnp.asarray(inp["v_codes"]), jcb["k_cb"], jcb["v_cb"],
        jnp.asarray(np.asarray(positions, np.int32)), chunk=CHUNK,
        quantize_q8=q8))
    assert got.shape == (B, KV * G, HD) and bool(torch.isfinite(got).all())
    tol = F32_TOL_REF if cb_dtype == "float32" else BF16_TOL
    assert _rel(got.numpy(), want) <= tol
    # a row with nothing live is 0 in both
    dead = np.asarray(positions) < 0
    assert not got.numpy()[dead].any() and not want[dead].any()


@pytest.mark.parametrize("cb_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("q8", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_split_order_matches_the_reference_order_twin(case, q8, cb_dtype):
    positions, split = case
    args = _torch_args(_inputs(28, cb_dtype), positions, q8)
    got = pqk.pq_decode_plain(*args, chunk=CHUNK, out_dtype=torch.float32,
                              split=split)
    want = pqk.pq_decode_plain(*args, chunk=CHUNK, out_dtype=torch.float32)
    tol = F32_TOL_TWIN if cb_dtype == "float32" else BF16_TOL
    assert _rel(got.numpy(), want.numpy()) <= tol


@pytest.mark.parametrize("q8", [True, False])
def test_one_live_split_equals_one_chunk_bit_for_bit(q8):
    # with every split but the first dead, the combine scales that split
    # by e^0 = 1 and adds exact zeros: the reference order over one chunk
    # of the split's length (f32 codebooks, whose product neither rounds)
    args = _torch_args(_inputs(29, "float32"), [3, 7], q8)
    got = pqk.pq_decode_plain(*args, chunk=8, out_dtype=torch.float32,
                              split=8)
    want = pqk.pq_decode_plain(*args, chunk=8, out_dtype=torch.float32)
    assert torch.equal(got, want)


def test_split_order_output_type_and_the_cpu_path():
    # bf16 out is the f32 result rounded once; the wrapper's CPU path
    # keeps the reference order
    args = _torch_args(_inputs(30, "bfloat16"), [13, 31], True)
    f32 = pqk.pq_decode_plain(*args, chunk=CHUNK, out_dtype=torch.float32,
                              split=12)
    bf16 = pqk.pq_decode_plain(*args, chunk=CHUNK, out_dtype=torch.bfloat16,
                               split=12)
    assert bf16.dtype == torch.bfloat16
    assert torch.equal(bf16, f32.to(torch.bfloat16))
    assert torch.equal(
        pqk.pq_decode(*args, chunk=CHUNK, out_dtype=torch.float32),
        pqk.pq_decode_plain(*args, chunk=CHUNK, out_dtype=torch.float32))


def test_split_count_and_combine_smem_follow_smax_alone():
    # the grid's splits: ceil(Smax / SPLIT), whatever the position
    assert pqk.SPLIT == 256
    assert [pqk.n_splits(s) for s in (1, 255, 256, 257, 300, 4096)] == \
        [1, 1, 1, 2, 2, 16]
    # a weight a split and the sum, in 16-byte units
    assert pqk.combine_smem_bytes(4096) == 80
    assert pqk.combine_smem_bytes(64) == 16
