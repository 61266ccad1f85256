"""The SegmentHead dropout of the port (mds_tpu_torch/ops/dropout.py) on the
CPU, where the wrapper runs its plain version: the same Philox4x32-10 bits
the CUDA kernel draws (csrc/dropout.cu; chip_smoke.py holds the two to each
other bit for bit on the card). JAX's kernel draws from the TPU's hardware
generator, so only its edge cases (rate 0 and 1) compare value for value;
the rest checks the rule: the keep rate, the bf16 scale, determinism per
seed, and a backward that regenerates the forward's mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mds_tpu.ops.pallas.dropout import dropout_u8_pallas
from mds_tpu_torch.models.layers import FastDropout
from mds_tpu_torch.ops import dropout as td

DROP = 26  # round(0.1 · 256)


@pytest.mark.parametrize("ctr,key,want", [
    # Random123's known answers for philox4x32_10
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF, 0xFFFFFFFF),
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    words = td.philox4x32_10(*(torch.tensor([c], dtype=torch.int64) for c in ctr), *key)
    assert tuple(int(w) for w in words) == want


def test_keep_fraction_and_bf16_scale():
    x = torch.from_numpy(np.random.default_rng(0).normal(0, 1, 10**6).astype(np.float32))
    x = x.to(torch.bfloat16)
    y = td.dropout_u8(x, 12345, 678, DROP)
    kept = y != 0
    assert abs(kept.float().mean().item() - 230 / 256) < 0.002
    scale = torch.tensor(256 / 230, dtype=torch.bfloat16)
    assert torch.equal(y[kept], (x[kept].float() * scale.float()).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and (x[~kept] != 0).all()


def test_determinism_per_seed():
    x = torch.randn(3, 8, 16, 16)
    a, b = td.dropout_u8(x, 1, 2, DROP), td.dropout_u8(x, 1, 2, DROP)
    assert torch.equal(a, b)
    for k0, k1 in ((1, 3), (2, 2)):
        assert not torch.equal(a != 0, td.dropout_u8(x, k0, k1, DROP) != 0)
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    assert td.seed_words(g[0]) == td.seed_words(g[1])


def test_mask_follows_storage_order():
    """Element i of the dense storage takes Philox word i % 4 of counter
    i // 4: a channels_last tensor and its NHWC-contiguous twin drop the
    same elements."""
    x = torch.randn(2, 5, 6, 7)
    cl = x.contiguous(memory_format=torch.channels_last)
    nhwc = x.permute(0, 2, 3, 1).contiguous()
    y = td.dropout_u8(cl, 9, 10, DROP)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y.permute(0, 2, 3, 1), td.dropout_u8(nhwc, 9, 10, DROP))
    words = td._random_words(x.numel(), 9, 10, "cpu")
    keep = ((words >> 24) >= DROP).reshape(nhwc.shape)
    assert torch.equal(y.permute(0, 2, 3, 1) != 0, keep)


@pytest.mark.parametrize("grad_format", [torch.channels_last, torch.contiguous_format])
def test_backward_regenerates_the_mask(grad_format):
    """The gradient of (y·r).sum() is r·mask·scale with y's zeros, for a
    channels_last x whose gradient arrives in either format."""
    x = torch.randn(2, 8, 6, 10).contiguous(memory_format=torch.channels_last)
    x.requires_grad_(True)
    r = torch.randn(2, 8, 6, 10).contiguous(memory_format=grad_format)
    y = td.DropoutU8.apply(x, 77, 88, DROP)
    (y * r).sum().backward()
    keep = y.detach() != 0
    assert torch.equal(x.grad, torch.where(keep, r * (256 / 230), 0.0))


def test_rate_zero_and_one_match_jax():
    x = np.random.default_rng(1).normal(0, 1, (2, 4, 8, 16)).astype(np.float32)
    seed = jnp.asarray([3, 4], jnp.int32)
    for rate in (0.0, 1.0):
        want, vjp = jax.vjp(lambda v: dropout_u8_pallas(v, seed, rate, True), jnp.asarray(x))
        (gwant,) = vjp(jnp.ones_like(want))
        t = torch.from_numpy(x).requires_grad_(True)
        got = td.dropout(t, rate, torch.Generator().manual_seed(0))
        if got.requires_grad:  # rate 1 returns zeros that hold no gradient
            got.sum().backward()
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        gx = t.grad if t.grad is not None else torch.zeros_like(t)
        np.testing.assert_array_equal(gx.numpy(), np.asarray(gwant))


def test_wrapper_checks():
    with pytest.raises(ValueError, match="drop"):
        td.dropout_u8(torch.ones(4), 0, 0, 0)
    with pytest.raises(ValueError, match="dense"):
        td.dropout_u8(torch.ones(4, 6)[:, ::2], 0, 0, DROP)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        td.dropout_u8(torch.ones(4, device="meta"), 0, 0, DROP)
    n = td.dropout_u8.launches
    td.dropout_u8(torch.ones(4), 0, 0, DROP)
    assert td.dropout_u8.launches == n  # the plain version is no launch


def test_fast_dropout_module():
    """Identity in eval and at rate 0; in train the generator's seed words
    decide the mask."""
    m = FastDropout(0.1)
    x = torch.randn(2, 4, 8, 8)
    m.eval()
    assert m(x) is x
    m.train()
    a = m(x, torch.Generator().manual_seed(1))
    b = m(x, torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and (a == 0).any()
    assert a.is_contiguous(memory_format=torch.channels_last)
    m.rate = 0.0
    assert m(x, torch.Generator().manual_seed(1)) is x
