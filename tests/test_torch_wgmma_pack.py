"""The weights that kernels 8, 7, 1, 2, 3, 4, 5 and 6 read through wgmma
descriptors, and the caches that pack them once per parameter version, on
the CPU.

`pack_conv3x3` (bf16(k), unscaled) and `pack_detail_tail` (bf16(k·scale) of
five convs) lay the weights out as csrc/wgmma.cuh's B operand. Here each
packed element is read back as the card addresses it: a k16 step's
descriptor starts 32 bytes per step into its 8 KB slice, 8-row groups lie
1024 bytes apart (the stride byte offset), rows 128 bytes, and the 128-byte
swizzle XORs address bits [4, 7) with bits [7, 10). The read-back must give
the weights exactly, zero where C_in or C_out is padded, at 64 → 64, 3 → 64
and 128 → 128.

`pack_stem` (kernels 1 and 2, csrc/stem.cu) splits the f32 folded table
(k·scale in the kernels' K order, the bias, zeros) into bf16 parts hi, mid,
lo in two slices of N rows, [hi | mid] and [lo | 0]. Read back the same way
at O = 8, 16, 24, 64, 128: hi + mid + lo is the f32 table exactly, hi + mid
within 2^-16 of it relative; for a bf16 weight with unit scale and no bias
(the training form) hi is the weight and mid, lo are zero.

`pack_stemblock` (kernel 5) holds the StemBlock's stem table as `pack_stem`
lays it out and bf16(k·scale) of left_1, left_2 and the fuse in 16-row
slices, column tap·C_in + ci; `pack_stem7` (kernel 6) the 7×7 stem's
bf16(k·scale) in N-row slices, column dy·24 + 1 + dx·3 + ci. Read back the
same way, k16 step by k16 step, zero wherever K or N is padded.

`PackCache` (models/layers.py) keeps a value until a source tensor changes:
reused across two eval calls, rebuilt after an in-place weight update, a BN
running-stat update and load_state_dict; the stems' tables likewise, on the
eval route and the training form.
"""

import numpy as np
import pytest
import torch

from mds_tpu_torch.models import bisenetv1 as tv1
from mds_tpu_torch.models import bisenetv2 as tb
from mds_tpu_torch.models import layers as tl
from mds_tpu_torch.models.resnet import Resnet18
from mds_tpu_torch.ops import conv3x3 as tc3
from mds_tpu_torch.ops import stem as tstem

SLICE = 8192  # bytes: 64 output × 64 input channels of one tap


def read_b(packed, slice_index, ks):
    """B(k, n) of k16 step ks of a slice, k < 16 and n < 64, as int16 bit
    patterns: the descriptor's start address, the stride byte offset, the
    128-byte rows, then the swizzle on the address bits."""
    k = np.arange(16).reshape(16, 1)
    n = np.arange(64).reshape(1, 64)
    a = slice_index * SLICE + ks * 32 + (n // 8) * 1024 + (n % 8) * 128 + k * 2
    a = a ^ (((a >> 7) & 7) << 4)
    return packed.view(torch.int16).numpy()[a // 2]


def expected_b(w, nh, tap, kc, ks):
    """The same B(k, n) from the OIHW weights (already bf16), zero-padded."""
    o, i = w.shape[:2]
    bits = w.to(torch.bfloat16).view(torch.int16).numpy()
    out = np.zeros((16, 64), np.int16)
    for n in range(64):
        for k in range(16):
            oc, ic = nh * 64 + n, kc * 64 + ks * 16 + k
            if oc < o and ic < i:
                out[k, n] = bits[oc, ic, tap // 3, tap % 3]
    return out


def weights(o, i, seed):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.normal(0, np.sqrt(2 / (9 * o)), (o, i, 3, 3)),
                        dtype=torch.float32)


@pytest.mark.parametrize("o,i", [(64, 64), (64, 3), (136, 24)])
def test_conv3x3_pack_reads_back(o, i):
    k = weights(o, i, o + i)
    packed = tc3.pack_conv3x3(k)
    nhs = -(-o // 64)
    assert packed.dtype == torch.bfloat16 and packed.numel() == nhs * 9 * 4096
    wb = k.to(torch.bfloat16)
    for nh in range(nhs):
        for tap in range(9):
            for ks in range(4):
                np.testing.assert_array_equal(
                    read_b(packed, nh * 9 + tap, ks), expected_b(wb, nh, tap, 0, ks))


def test_detail_tail_pack_reads_back():
    """Every conv of the tail, the 128 → 128 ones with two K chunks per tap,
    at slices [conv][nh][tap][kc] from the offsets csrc/detail_tail.cu
    names (kSl4..kSl8)."""
    rng = np.random.default_rng(1)
    params = []
    for o, i in tstem._TAIL_SHAPES:
        params += [weights(o, i, o * i),
                   torch.tensor(rng.normal(1, .1, o), dtype=torch.float32),
                   torch.tensor(rng.normal(0, .1, o), dtype=torch.float32)]
    wp, bp = tstem.pack_detail_tail(*params)
    assert wp.numel() * 2 == 108 * SLICE
    np.testing.assert_array_equal(bp.numpy(), torch.cat(params[2::3]).numpy())
    first = 0
    for c, (o, i) in enumerate(tstem._TAIL_SHAPES):
        wb = tstem._fold_bf16(params[3 * c], params[3 * c + 1])
        kcs = i // 64
        for nh in range(o // 64):
            for tap in (0, 4, 8):
                for kc in range(kcs):
                    for ks in (0, 3):
                        sl = first + (nh * 9 + tap) * kcs + kc
                        np.testing.assert_array_equal(
                            read_b(wp, sl, ks), expected_b(wb, nh, tap, kc, ks))
        first += (o // 64) * 9 * kcs
    assert first == 108


def test_pack_cache_keys_on_versions():
    k = weights(64, 64, 0)
    cache = tl.PackCache()
    build = lambda: tc3.pack_conv3x3(k)  # noqa: E731
    a = cache.get("w", (k,), build)
    assert cache.get("w", (k,), build) is a and cache.builds == 1
    with torch.no_grad():
        k.mul_(2)  # an optimizer step: in place, the version moves
    b = cache.get("w", (k,), build)
    assert cache.builds == 2 and torch.equal(b, tc3.pack_conv3x3(k))
    k2 = k.clone()  # the same values in new storage (.to(), a copy)
    cache.get("w", (k2,), lambda: tc3.pack_conv3x3(k2))
    assert cache.builds == 3


def _conv3_module():
    tm = tl.ConvBNReLU(16, 16, 3, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for t in (tm.conv.weight, tm.affine_weight, tm.affine_bias,
                  tm.bn[0].running_mean):
            t.copy_(torch.randn(t.shape, generator=g) * 0.1 + (t is tm.affine_weight))
        tm.bn[0].running_var.copy_(torch.rand(16, generator=g) + 0.5)
    return tm.eval()


def _run(tm, x):
    tl.set_conv3_eval_impl("kernel")
    try:
        with torch.no_grad():
            return tm([x])[0]
    finally:
        tl.set_conv3_eval_impl("plain")


def test_conv3_route_reuses_and_rebuilds_its_fold():
    """The conv3 route's folded (scale, bias) on CPU tensors: one build over
    two eval calls; a rebuild after each of an in-place weight update, a BN
    running-stat update (a train-mode forward) and load_state_dict, each
    with the output of a fresh module."""
    tm = _conv3_module()
    x = torch.randn((1, 16, 512, 8), generator=torch.Generator().manual_seed(1)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    first = _run(tm, x)
    assert torch.equal(_run(tm, x), first) and tm._packs.builds == 1

    def fresh():
        m = _conv3_module()
        m.load_state_dict(tm.state_dict())
        return _run(m.eval(), x)

    with torch.no_grad():
        tm.affine_weight.mul_(1.5)
    got = _run(tm, x)
    assert tm._packs.builds == 2 and not torch.equal(got, first)
    assert torch.equal(got, fresh())

    tm.train()
    with torch.no_grad():
        tm([x.float()])  # train BN: the running stats move in place
    tm.eval()
    got = _run(tm, x)
    assert tm._packs.builds == 3 and torch.equal(got, fresh())

    state = {k: v.clone() for k, v in _conv3_module().state_dict().items()}
    tm.load_state_dict(state)
    got = _run(tm, x)
    assert tm._packs.builds == 4 and torch.equal(got, _run(_conv3_module(), x))


def test_detail_tail_route_folds_once_per_version(monkeypatch):
    """The DetailBranch tail's five folds: built once over two eval calls,
    rebuilt for the module whose BN stats moved."""
    tm = tb.DetailBranch(n_bn=1, dtype=torch.bfloat16).eval()
    x = torch.randn((1, 3, 32, 32), generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    tl.set_detail_fuse(True)
    tl.set_detail_tail(True)
    try:
        with torch.no_grad():
            a = tm([x])[0]
            b = tm([x])[0]
            assert torch.equal(a, b)
            assert [m._packs.builds for m in tm._tail()] == [1] * 5
            tm.S3_2.bn[0].running_mean.add_(0.5)
            tm([x])
    finally:
        tl.set_detail_fuse(False)
        tl.set_detail_tail(False)
    assert [m._packs.builds for m in tm._tail()] == [1, 1, 1, 2, 1]


def read_stem(packed, n_rows, part):
    """Table column j < 32 of part 0 (hi), 1 (mid) or 2 (lo) for every row
    n < n_rows, as kernels 1 and 2 address it: part p in slice p // 2 at
    n_rows · 128 bytes per slice, k16 step (p % 2) · 2 + j // 16 at 32 bytes
    a step, 8-row groups 1024 bytes apart, rows 128 bytes, the swizzle."""
    j = np.arange(32).reshape(1, 32)
    n = np.arange(n_rows).reshape(n_rows, 1)
    step = (part % 2) * 2 + j // 16
    a = ((part // 2) * n_rows * 128 + step * 32 + (n // 8) * 1024 + (n % 8) * 128
         + (j % 16) * 2)
    a = a ^ (((a >> 7) & 7) << 4)
    bits = packed.view(torch.int16).numpy()[a // 2].astype(np.int32) << 16
    return bits.astype(np.uint32).view(np.float32)


def stem_table(k, scale, bias):
    """The (O, 32) f32 table in csrc/stem.cu's K order, written out tap by
    tap: column dy·10 + 1 + dx·3 + ci holds k·scale, 30 the bias."""
    o = k.shape[0]
    w = (k.double() * scale.double().reshape(-1, 1, 1, 1)).float().numpy()
    t = np.zeros((o, 32), np.float32)
    for dy in range(3):
        for dx in range(3):
            for ci in range(3):
                t[:, dy * 10 + 1 + dx * 3 + ci] = w[:, ci, dy, dx]
    t[:, 30] = bias.numpy()
    return t


@pytest.mark.parametrize("o", [8, 16, 24, 64, 128])
def test_stem_pack_reads_back(o):
    rng = np.random.default_rng(o)
    k = torch.tensor(rng.normal(0, np.sqrt(2 / (9 * o)), (o, 3, 3, 3)), dtype=torch.float32)
    scale = torch.tensor(rng.normal(1, 0.1, o), dtype=torch.float32)
    bias = torch.tensor(rng.normal(0, 0.1, o), dtype=torch.float32)
    n = tstem._stem_n(o)
    assert n >= o and n in (16, 32, 64, 128)
    packed = tstem.pack_stem(k, scale, bias)
    assert packed.dtype == torch.bfloat16 and packed.numel() == 2 * n * 64
    hi, mid, lo = (read_stem(packed, n, p) for p in range(3))
    assert not hi[o:].any() and not mid[o:].any() and not lo[o:].any()
    want = stem_table(k, scale, bias)
    np.testing.assert_array_equal(hi[:o] + mid[:o] + lo[:o], want)
    assert np.abs(hi[:o] + mid[:o] - want).max() <= 2.0 ** -16 * np.abs(want).max()
    np.testing.assert_array_equal(
        hi[:o], torch.from_numpy(want).to(torch.bfloat16).float().numpy())
    # the fourth part of slice 1 is zero
    tail = read_stem(packed, n, 3)
    assert not tail.any()


@pytest.mark.parametrize("o", [16, 64])
def test_stem_pack_of_the_training_form(o):
    """A bf16 weight, unit scale, no bias: hi is the weight, mid = lo = 0."""
    rng = np.random.default_rng(o + 1)
    kb = torch.tensor(rng.normal(0, 0.3, (o, 3, 3, 3)), dtype=torch.float32).to(torch.bfloat16)
    packed = tstem.pack_stem(kb)
    n = tstem._stem_n(o)
    hi, mid, lo = (read_stem(packed, n, p) for p in range(3))
    np.testing.assert_array_equal(hi[:o], stem_table(kb.float(), torch.ones(o), torch.zeros(o)))
    assert not mid.any() and not lo.any()


def _stem_module():
    tm = tl.ConvBNReLU(3, 16, 3, stride=2, dtype=torch.bfloat16)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for t in (tm.conv.weight, tm.affine_weight, tm.affine_bias, tm.bn[0].running_mean):
            t.copy_(torch.randn(t.shape, generator=g) * 0.1 + (t is tm.affine_weight))
        tm.bn[0].running_var.copy_(torch.rand(16, generator=g) + 0.5)
    return tm.eval()


def test_stem_routes_pack_once_per_version(monkeypatch):
    """The eval stem route's table (with its fold) and the training form's:
    one build over two calls; rebuilt after an in-place weight update (both)
    and a BN running-stat update (the eval table); the table handed to the
    wrapper is pack_stem of the current values."""
    seen = []
    real = tstem.stem_conv_bn_relu_s2

    def spy(x, k, scale, bias, relu=False, packed=None):
        seen.append(packed)
        return real(x, k, scale, bias, relu, packed)

    monkeypatch.setattr(tstem, "stem_conv_bn_relu_s2", spy)
    tm = _stem_module()
    x = torch.randn((1, 3, 16, 24), generator=torch.Generator().manual_seed(4)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    tl.set_stem_impl("kernel")
    try:
        with torch.no_grad():
            tm([x])
            tm([x])
            assert tm._packs.builds == 2 and seen[0] is seen[1]  # fold + table
            tm.conv.weight.mul_(1.5)
            tm([x])
            assert tm._packs.builds == 3  # the table; the fold keys on the BN
            tm.bn[0].running_var.add_(0.25)
            tm([x])
            assert tm._packs.builds == 5
            scale, bias = tm.fold_cached(0)
            assert torch.equal(seen[-1], tstem.pack_stem(
                tm.conv.weight.to(torch.bfloat16), scale, bias))

            conv = tm.conv.train()
            for _ in range(2):
                y = conv.conv(x, torch.bfloat16)
            assert conv._packs.builds == 1 and y.dtype == torch.float32
            conv.weight.add_(0.01)
            conv.conv(x, torch.bfloat16)
            assert conv._packs.builds == 2
            assert torch.equal(conv._packs._entries["train"][1],
                               tstem.pack_stem(conv.weight.to(torch.bfloat16)))
    finally:
        tl.set_stem_impl("plain")


def _head_params(seed):
    rng = np.random.default_rng(seed)
    params = []
    for o, i in ((64, 3), (64, 64), (64, 64)):
        params += [weights(o, i, seed + i),
                   torch.tensor(rng.normal(1, .1, o), dtype=torch.float32),
                   torch.tensor(rng.normal(0, .1, o), dtype=torch.float32)]
    return params


def test_detail_head_pack_reads_back():
    """Kernel 4's weights: S1_1's f32 table in three bf16 parts read back as
    kernels 1 and 2 address it (exact sum), S1_2 and S2_1's bf16(k·scale) as
    9 slices each through the descriptor and swizzle addressing, the f32
    biases as they are."""
    params = _head_params(5)
    t1, w2p, b2, w3p, b3 = tstem.pack_detail_head(*params)
    hi, mid, lo = (read_stem(t1, 64, p) for p in range(3))
    np.testing.assert_array_equal(hi + mid + lo, stem_table(*params[:3]))
    for packed, (k, s) in ((w2p, params[3:5]), (w3p, params[6:8])):
        assert packed.dtype == torch.bfloat16 and packed.numel() * 2 == 9 * SLICE
        wb = tstem._fold_bf16(k, s)
        for tap in range(9):
            for ks in range(4):
                np.testing.assert_array_equal(read_b(packed, tap, ks),
                                              expected_b(wb, 0, tap, 0, ks))
    np.testing.assert_array_equal(b2.numpy(), params[5].numpy())
    np.testing.assert_array_equal(b3.numpy(), params[8].numpy())
    with pytest.raises(ValueError, match="bad kernel shapes"):
        tstem.pack_detail_head(*params[:3], weights(64, 32, 0), *params[4:])


def test_s1_pair_pack_reads_back():
    """Kernel 3's weights: S1_1's f32 table in three bf16 parts read back as
    kernels 1 and 2 address it (exact sum), S1_2's bf16(k·scale) as 9 slices
    through the descriptor and swizzle addressing, its f32 bias as it is;
    the same as kernel 4's first three."""
    params = _head_params(7)[:6]
    t1, w2p, b2 = tstem.pack_s1_pair(*params)
    hi, mid, lo = (read_stem(t1, 64, p) for p in range(3))
    np.testing.assert_array_equal(hi + mid + lo, stem_table(*params[:3]))
    assert w2p.dtype == torch.bfloat16 and w2p.numel() * 2 == 9 * SLICE
    wb = tstem._fold_bf16(params[3], params[4])
    for tap in range(9):
        for ks in range(4):
            np.testing.assert_array_equal(read_b(w2p, tap, ks),
                                          expected_b(wb, 0, tap, 0, ks))
    assert b2.dtype == torch.float32
    np.testing.assert_array_equal(b2.numpy(), params[5].numpy())
    head = tstem.pack_detail_head(*params, *_head_params(8)[6:])
    for a, b in zip((t1, w2p, b2), head):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="bad kernel shapes"):
        tstem.pack_s1_pair(*params[:3], weights(64, 32, 0), *params[4:])


def test_detail_head_route_packs_once_per_version():
    """The DetailBranch head's three folds and its pack: each built once over
    two eval calls, rebuilt after an in-place weight update and a BN
    running-stat update, and the pack handed to the kernel is
    pack_detail_head of the current values. (A CPU input runs the plain
    version, which reads no pack: the pack's cache is driven here with an
    input on the meta device, as a CUDA one would.)"""
    tm = tb.DetailBranch(n_bn=1, dtype=torch.bfloat16).eval()
    x = torch.randn((1, 3, 16, 24), generator=torch.Generator().manual_seed(6)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    meta = torch.empty(1, device="meta")

    def pack():
        params = [t for m in tm._head() for t in (m.conv.weight, *m.fold_cached(0))]
        return tb._pack_cached(tm, "head", tm._head(), 0, tstem.pack_detail_head,
                               params, meta)

    tl.set_detail_fuse(True)
    try:
        with torch.no_grad():
            a = tm([x])[0]
            assert torch.equal(tm([x])[0], a)
            assert [m._packs.builds for m in tm._head()] == [1, 1, 1]
            first = pack()
            assert pack() is first and tm._packs.builds == 1
            tm.S1_2.conv.weight.mul_(1.5)
            assert pack() is not first and tm._packs.builds == 2
            tm.S2_1.bn[0].running_var.add_(0.25)
            got = pack()
            assert tm._packs.builds == 3
            assert [m._packs.builds for m in tm._head()] == [1, 1, 2]
            params = [t for m in tm._head() for t in (m.conv.weight, *m.fold_cached(0))]
            for g, w in zip(got, tstem.pack_detail_head(*params)):
                assert torch.equal(g, w)
            assert tb._pack_cached(tm, "head", tm._head(), 0, tstem.pack_detail_head,
                                   params, x) is None
    finally:
        tl.set_detail_fuse(False)


def test_depthwise_route_casts_once_per_version():
    """The depthwise route's bf16 weight: cast once over two eval calls under
    no_grad, again after an in-place weight update; under grad the layer
    hands the wrapper the weight itself, which it refuses."""
    tm = tl.ConvBNReLU(8, 48, 3, groups=8, dtype=torch.bfloat16).eval()
    x = torch.randn((1, 8, 9, 13), generator=torch.Generator().manual_seed(7)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    tl.set_depthwise_impl("kernel")
    try:
        with torch.no_grad():
            a = tm([x])[0]
            assert torch.equal(tm([x])[0], a)
            builds = tm._packs.builds  # the fold and the cast
            assert torch.equal(tm._packs._entries["dw"][1],
                               tm.conv.weight.to(torch.bfloat16))
            tm.conv.weight.mul_(-1)
            b = tm([x])[0]
            assert tm._packs.builds == builds + 1 and not torch.equal(a, b)
            assert torch.equal(tm._packs._entries["dw"][1],
                               tm.conv.weight.to(torch.bfloat16))
        with pytest.raises(RuntimeError, match="has no backward"):
            tm([x])
    finally:
        tl.set_depthwise_impl("plain")


def read_steps(packed, n_rows, steps):
    """B(k, n) for k < 16·steps and n < n_rows, as f32 values, as a kernel
    whose slices are n_rows × 128 bytes addresses it: k16 step k // 16 in
    slice k // 64 at 32 bytes a step, 8-row groups 1024 bytes apart, rows 128
    bytes, then the swizzle on the address bits."""
    k = np.arange(16 * steps).reshape(-1, 1)
    n = np.arange(n_rows).reshape(1, -1)
    a = ((k // 64) * n_rows * 128 + (k % 64 // 16) * 32 + (n // 8) * 1024
         + (n % 8) * 128 + (k % 16) * 2)
    a = a ^ (((a >> 7) & 7) << 4)
    bits = packed.view(torch.int16).numpy()[a // 2].astype(np.int32) << 16
    return bits.astype(np.uint32).view(np.float32)


def bf16_folded(k, scale):
    """bf16(k·scale) per output channel, as f32 values (OIHW)."""
    return (k * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16).float().numpy()


def _bn_params(rng, o):
    return (torch.tensor(rng.normal(1, 0.1, o), dtype=torch.float32),
            torch.tensor(rng.normal(0, 0.1, o), dtype=torch.float32))


@pytest.mark.parametrize("o", [8, 24, 64, 128])
def test_stem7_pack_reads_back(o):
    """Kernel 6's B: 11 k16 steps (K = 7 rows × 24, then the bias) through
    three slices of N rows: column dy·24 + 1 + dx·3 + ci holds bf16(k·scale)
    at (dy, dx, ci), column 168 bf16(bias); columns dy·24, dy·24 + 22,
    dy·24 + 23, 169 onwards and rows past O are zero."""
    rng = np.random.default_rng(o + 2)
    k = torch.tensor(rng.normal(0, 0.1, (o, 3, 7, 7)), dtype=torch.float32)
    scale, bias = _bn_params(rng, o)
    wp = tstem.pack_stem7(k, scale, bias)
    n = tstem._stem_n(o)
    assert wp.dtype == torch.bfloat16 and wp.numel() == 3 * 64 * n
    got = read_steps(wp, n, 12)  # K 0..191: the three slices whole
    want = np.zeros((192, n), np.float32)
    wb = bf16_folded(k, scale)
    for dy in range(7):
        for dx in range(7):
            for ci in range(3):
                want[dy * 24 + 1 + dx * 3 + ci, :o] = wb[:, ci, dy, dx]
    want[168, :o] = bias.to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="pack_stem7"):
        tstem.pack_stem7(k[:, :, :5, :5], scale, bias)


def _stemblock_params(seed):
    rng = np.random.default_rng(seed)
    params = []
    for o, i, ks in ((16, 3, 3), (8, 16, 1), (16, 8, 3), (16, 32, 3)):
        params += [torch.tensor(rng.normal(0, np.sqrt(2 / (ks * ks * o)), (o, i, ks, ks)),
                                dtype=torch.float32), *_bn_params(rng, o)]
    return params


def test_stemblock_pack_reads_back():
    """Kernel 5's weights: the stem's table in three bf16 parts as kernels 1
    and 2 address it (hi + mid + lo is the f32 fold exactly), then left_1 (K
    = 16 channels, rows 8-15 zero), left_2 (column tap·8 + ci, zero from 72)
    and the fuse (column tap·32 + ci, zero from 288), 16-row slices read
    step by step; the f32 biases of left_1, left_2 and the fuse in order."""
    params = _stemblock_params(9)
    w, bias = tstem.pack_stemblock(*params)
    assert w.dtype == torch.bfloat16 and w.numel() == 10 * 1024
    hi, mid, lo = (read_stem(w[:2048], 16, p) for p in range(3))
    np.testing.assert_array_equal(hi + mid + lo, stem_table(*params[:3]))
    assert not read_stem(w[:2048], 16, 3).any()
    l1, l2, fu = (bf16_folded(params[i], params[i + 1]) for i in (3, 6, 9))
    want = np.zeros((64, 16), np.float32)
    want[:16, :8] = l1[:, :, 0, 0].T
    np.testing.assert_array_equal(read_steps(w[2048:3072], 16, 4), want)
    for part, (wb, cin, steps) in ((w[3072:5120], (l2, 8, 8)), (w[5120:], (fu, 32, 20))):
        want = np.zeros((16 * steps, 16), np.float32)
        for dy in range(3):
            for dx in range(3):
                for ci in range(cin):
                    want[(dy * 3 + dx) * cin + ci] = wb[:, ci, dy, dx]
        np.testing.assert_array_equal(read_steps(part, 16, steps), want)
    np.testing.assert_array_equal(
        bias.numpy(), torch.cat([params[5], params[8], params[11]]).numpy())
    with pytest.raises(ValueError, match="bad kernel shapes"):
        tstem.pack_stemblock(*params[:9], params[9][:, :16], *params[10:])


def _randomize(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.named_parameters():
            t.copy_(torch.randn(t.shape, generator=g) * 0.1 + name.endswith(
                ("affine_weight", "bn.weight", "bn1.weight")))
        for name, t in module.named_buffers():
            if name.endswith("running_mean"):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
    return module.eval()


def test_stemblock_route_packs_once_per_version():
    """The StemBlock's four folds and its pack: built once over two eval
    calls, rebuilt after an in-place weight update, a BN running-stat update
    and load_state_dict, and the pack handed to the kernel is
    pack_stemblock of the current values. (A CPU input runs the plain
    version, which reads no pack: the pack's cache is driven with an input
    on the meta device, as a CUDA one would.)"""
    tm = _randomize(tb.StemBlock(n_bn=1, dtype=torch.bfloat16), 10)
    x = torch.randn((1, 3, 16, 24), generator=torch.Generator().manual_seed(11)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    meta = torch.empty(1, device="meta")

    def params():
        return [t for m in tm._convs() for t in (m.conv.weight, *m.fold_cached(0))]

    def pack():
        return tb._pack_cached(tm, "stemblock", tm._convs(), 0, tstem.pack_stemblock,
                               params(), meta)

    tl.set_detail_fuse(True)
    try:
        with torch.no_grad():
            a = tm([x])[0]
            assert torch.equal(tm([x])[0], a)
            assert [m._packs.builds for m in tm._convs()] == [1] * 4
            first = pack()
            assert pack() is first and tm._packs.builds == 1
            tm.left_2.conv.weight.mul_(1.5)
            assert pack() is not first and tm._packs.builds == 2
            tm.fuse.bn[0].running_var.add_(0.25)
            got = pack()
            assert tm._packs.builds == 3
            assert [m._packs.builds for m in tm._convs()] == [1, 1, 1, 2]
            for g, w in zip(got, tstem.pack_stemblock(*params())):
                assert torch.equal(g, w)
            tm.load_state_dict({k: v.clone() for k, v in tm.state_dict().items()})
            pack()
            assert tm._packs.builds == 4
            assert [m._packs.builds for m in tm._convs()] == [2, 2, 2, 3]
            assert tb._pack_cached(tm, "stemblock", tm._convs(), 0, tstem.pack_stemblock,
                                   params(), x) is None
            assert torch.equal(tm([x])[0], tb.StemBlock.forward(tm, [x])[0])
    finally:
        tl.set_detail_fuse(False)


@pytest.mark.parametrize("owner", ["resnet18", "convbnrelu1"])
def test_stem7_route_packs_once_per_version(owner, monkeypatch):
    """The 7×7 route's fold and pack, held by Resnet18 and ConvBNReLU1 (the
    two 7×7 stems of BiSeNetV1): a second forward builds nothing; an
    in-place weight update rebuilds the pack, a BN running-stat update and
    load_state_dict the fold and the pack; the pack handed to the kernel is
    pack_stem7 of the current values. A CPU input makes the fold and no pack
    (its plain version reads none); the pack is driven with an input on the
    meta device, as a CUDA one would, the wrapper stood in for."""
    if owner == "resnet18":
        tm = _randomize(Resnet18(dtype=torch.bfloat16), 12)
        conv, bn = tm.conv1, tm.bn1

        def fwd(x):
            return tl.conv_bn_relu(tm.conv1, tm.bn1, x, torch.bfloat16, tm._packs)
    else:
        tm = _randomize(tv1.ConvBNReLU1(3, 64, 7, 2, 3, dtype=torch.bfloat16), 12)
        conv, bn, fwd = tm.conv, tm.bn, tm
    seen = []
    real = tstem.stem7_conv_bn_relu_s2

    def spy(x, k, scale, bias, relu=True, packed=None):
        seen.append(packed)
        if x.device.type == "meta":
            return torch.empty((x.shape[0], k.shape[0], x.shape[2] // 2, x.shape[3] // 2),
                               device="meta")
        return real(x, k, scale, bias, relu, packed)

    monkeypatch.setattr(tstem, "stem7_conv_bn_relu_s2", spy)
    x = torch.randn((1, 3, 16, 24), generator=torch.Generator().manual_seed(13)
                    ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    meta = torch.empty((1, 3, 16, 24), dtype=torch.bfloat16, device="meta")
    tl.set_stem_impl("kernel")
    try:
        with torch.no_grad():
            a = tm(x) if owner == "convbnrelu1" else tm(x)[0]
            b = tm(x) if owner == "convbnrelu1" else tm(x)[0]
            assert torch.equal(a, b) and tm._packs.builds == 1  # the fold alone
            assert seen == [None, None]
            fwd(meta)
            fwd(meta)
            assert tm._packs.builds == 2 and seen[2] is seen[3] is not None
            conv.weight.mul_(1.5)
            fwd(meta)
            assert tm._packs.builds == 3  # the pack; the fold keys on the BN
            bn.running_var.add_(0.25)
            fwd(meta)
            assert tm._packs.builds == 5
            scale, bias = tl.bn_fold(bn)
            assert torch.equal(seen[-1], tstem.pack_stem7(conv.weight, scale, bias))
            tm.load_state_dict({k: v.clone() for k, v in tm.state_dict().items()})
            fwd(meta)
            assert tm._packs.builds == 7
    finally:
        tl.set_stem_impl("plain")
