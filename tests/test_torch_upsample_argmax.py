"""The port's fused upsample + argmax (mds_tpu_torch/ops/upsample_argmax.py)
against the JAX Pallas kernel mds_tpu/ops/pallas/upsample_argmax.py in
interpret mode on the CPU, at the shapes of tests/test_upsample_argmax.py.

On a CPU tensor the wrapper runs its plain version, which defines what the
CUDA kernel computes (the card-side comparison lives in chip_smoke.py). f32
label maps are expected to be equal (agreement gate 0.9999: each product is
rounded once either way, and XLA may contract one into an FMA); bf16 ones
on i.i.d. logits, the worst case for near-ties, agree on ≥ 0.999."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.ops.pallas import upsample_argmax as jua
from mds_tpu_torch.ops import upsample_argmax as tua
from torch_parity import interpret_pallas, nchw

SHAPES = [((1, 8, 16, 19), 8), ((2, 16, 8, 5), 4), ((1, 12, 12, 3), 2)]


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    interpret_pallas(monkeypatch)


def _agreement(logits, scale, got, want):
    """Share of equal labels; every differing pixel printed with the two
    top logits of its f32 upsampled class vector."""
    diff = np.argwhere(got != want)
    if len(diff):
        b, h, w, c = logits.shape
        vol = np.asarray(jax.image.resize(jnp.asarray(logits, jnp.float32),
                                          (b, h * scale, w * scale, c), "linear"))
        for n, y, x in diff[:20]:
            top = np.sort(vol[n, y, x])[-2:][::-1]
            print(f"pixel {(n, y, x)}: port {got[n, y, x]} jax {want[n, y, x]} "
                  f"top logits {top}")
    return float((got == want).mean())


@pytest.mark.parametrize("shape,scale", SHAPES)
def test_plain_matches_pallas_f32(shape, scale):
    logits = np.random.default_rng(1).normal(0, 1, shape).astype(np.float32)
    want = np.asarray(jua.upsample_argmax_pallas(jnp.asarray(logits), scale))
    got = tua.upsample_argmax(nchw(logits), scale)
    assert got.dtype == torch.int32
    assert tuple(got.shape) == want.shape == (shape[0], shape[1] * scale,
                                              shape[2] * scale)
    assert _agreement(logits, scale, got.numpy(), want) >= 0.9999


def test_plain_matches_pallas_bf16():
    logits = np.random.default_rng(2).normal(0, 1, (1, 16, 32, 19)).astype(np.float32)
    lj = jnp.asarray(logits, jnp.bfloat16)
    want = np.asarray(jua.upsample_argmax_pallas(lj, 8))
    got = tua.upsample_argmax(nchw(np.asarray(lj, np.float32), torch.bfloat16), 8)
    assert _agreement(np.asarray(lj, np.float32), 8, got.numpy(), want) >= 0.999


@pytest.mark.parametrize("n_in,scale", [(8, 8), (16, 4), (5, 8), (12, 2), (7, 3),
                                        (4, 1)])
def test_interp_taps_match_interp_matrix(n_in, scale):
    """The two taps of each output row, as a dense matrix, equal
    interp_matrix's row, in f32 and rounded to bf16 as JAX's kernel rounds
    it."""
    want = jua.interp_matrix(n_in, n_in * scale)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        lo, hi, w_lo, w_hi = tua.interp_taps(n_in, scale, dtype)
        dense = torch.zeros(n_in * scale, n_in)
        rows = torch.arange(n_in * scale)
        dense[rows, lo] += w_lo
        dense[rows, hi] += w_hi
        np.testing.assert_array_equal(
            dense.numpy(), np.asarray(jnp.asarray(want, jdt), np.float32))


@pytest.mark.parametrize("scale", range(1, 9))
@pytest.mark.parametrize("n_in", [1, 5, 255])
def test_phase_taps_match_interp_matrix(n_in, scale):
    """The kernel's table by run kind and phase, spread over every output
    row (run j = floor((i − scale//2) / scale), phase the rest; kind 0 for
    run −1, 2 for run n_in − 1, else 1), equals interp_matrix's rows, in
    f32 and rounded to bf16: the weights depend on nothing else."""
    want = jua.interp_matrix(n_in, n_in * scale)
    i = torch.arange(n_in * scale)
    j = torch.div(i - scale // 2, scale, rounding_mode="floor")
    p = i - scale // 2 - j * scale
    kind = torch.where(j < 0, 0, torch.where(j == n_in - 1, 2, 1))
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        tbl = tua.phase_taps(n_in, scale, dtype)
        assert tbl.shape == (3, scale, 2) and tbl.dtype == torch.float32
        dense = torch.zeros(n_in * scale, n_in)
        dense.index_put_((i, j.clamp(0, n_in - 1)), tbl[kind, p, 0], accumulate=True)
        dense.index_put_((i, (j + 1).clamp(0, n_in - 1)), tbl[kind, p, 1], accumulate=True)
        np.testing.assert_array_equal(
            dense.numpy(), np.asarray(jnp.asarray(want, jdt), np.float32))


def test_ties_take_the_first_class():
    logits = np.zeros((1, 3, 5, 4), np.float32)
    got = tua.upsample_argmax(nchw(logits), 8)
    assert torch.equal(got, torch.zeros(1, 24, 40, dtype=torch.int32))
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 1, (1, 3, 5, 6)).astype(np.float32)
    logits[..., 2] = logits[..., 4] = np.abs(logits).max() + 1  # a two-way tie
    for dt in (torch.float32, torch.bfloat16):
        got = tua.upsample_argmax(nchw(logits, dt), 4)
        assert torch.equal(got, torch.full((1, 12, 20), 2, dtype=torch.int32))
    want = np.asarray(jua.upsample_argmax_pallas(jnp.asarray(logits), 4))
    assert (want == 2).all()


def test_wrapper_checks():
    with pytest.raises(ValueError):
        tua.upsample_argmax(torch.empty((1, 5, 4, 4), device="meta"), 8)
    with pytest.raises(ValueError, match="scale"):
        tua.upsample_argmax(torch.zeros(1, 5, 4, 4), 0)
    with pytest.raises(ValueError):
        tua.upsample_argmax(torch.zeros(1, 5, 4, 4, dtype=torch.float16), 2)
    assert tua.upsample_argmax.launches == 0
