"""PyTorch building blocks of the port: per-dataset BN, conv blocks, heads.

Counterparts of mds_tpu/models/layers.py for the eval and the train path.
Multi-dataset activations flow as per-dataset lists where an absent dataset
is None. Tensors are logically NCHW and stored channels_last; the compute
dtype is explicit (`dtype`, bf16 for serving and training), params and BN
math are f32. `module.train()` / `.eval()` select the mode, as `train=` does
in the JAX package: in train mode BN normalizes with batch moments and
updates its running stats, the SegmentHead dropout is on, and the fused eval
routes (stem kernel, detail/StemBlock fusion and tail, conv3 kernel) are off.

The module and buffer names follow the reference torch layout that
mds_tpu_torch/deploy/weights.py speaks (`<block>.conv.weight`,
`<block>.affine_weight`, `<block>.bn.{i}.running_mean`, ...).
"""

from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.ops.dropout import dropout
from mds_tpu_torch.parallel import mesh

MultiX = Sequence[Optional[torch.Tensor]]
Coeffs = List[Optional[Tuple[torch.Tensor, torch.Tensor]]]


def lmap(fn: Callable, xs: MultiX) -> List[Optional[torch.Tensor]]:
    """Map over a per-dataset list, passing None through."""
    return [None if x is None else fn(x) for x in xs]


def lmap2(fn: Callable, xs: MultiX, ys: MultiX) -> List[Optional[torch.Tensor]]:
    return [None if (x is None or y is None) else fn(x, y)
            for x, y in zip(xs, ys)]


def as_multi(x: torch.Tensor, dataset: int, n: int) -> List[Optional[torch.Tensor]]:
    """Wrap a single-dataset tensor into the list form."""
    return [x if i == dataset else None for i in range(n)]


# Stem route for the stride-2 RGB convs in eval: "plain" (library conv) or
# "kernel" (ops/stem.py with the BN folded in: stem_conv_bn_relu_s2 for the
# 3×3 stems, stem7_conv_bn_relu_s2 for the 7×7 ones).
_STEM_IMPL = "plain"


def set_stem_impl(impl: str) -> None:
    if impl not in ("plain", "kernel"):
        raise ValueError(f"stem impl must be 'plain' or 'kernel', got {impl!r}")
    global _STEM_IMPL
    _STEM_IMPL = impl


def get_stem_impl() -> str:
    return _STEM_IMPL


# Deploy fusion of the DetailBranch S1_1+S1_2+S2_1 and of the whole StemBlock
# into one kernel each (ops/stem.py detail_s1s2_fused, stemblock_fused).
_DETAIL_FUSE = False


def set_detail_fuse(enable: bool = True) -> None:
    global _DETAIL_FUSE
    _DETAIL_FUSE = enable


def get_detail_fuse() -> bool:
    return _DETAIL_FUSE


# With the detail fusion on, the rest of the DetailBranch (S2_2 … S3_3) as one
# more kernel (ops/stem.py detail_tail_fused; mds_tpu/models/layers.py:258-267).
_DETAIL_TAIL = False


def set_detail_tail(enable: bool = True) -> None:
    global _DETAIL_TAIL
    _DETAIL_TAIL = enable


def get_detail_tail() -> bool:
    return _DETAIL_TAIL


# Eval route of the 3×3 stride-1 convs with C_in <= 64 at H >= 512 in bf16:
# "plain" (library conv, then the BN) or "kernel" (ops/conv3x3.py
# conv3x3_bn_relu with the BN folded in; mds_tpu/models/layers.py:205-211's
# "pallas"). On a 1024×2048 frame only the DetailBranch's S1_2 qualifies, on
# the stem route without the detail fusion.
_CONV3_EVAL_IMPL = "plain"


def set_conv3_eval_impl(impl: str) -> None:
    if impl not in ("plain", "kernel"):
        raise ValueError(f"conv3 eval impl must be 'plain' or 'kernel', got {impl!r}")
    global _CONV3_EVAL_IMPL
    _CONV3_EVAL_IMPL = impl


def get_conv3_eval_impl() -> str:
    return _CONV3_EVAL_IMPL


# Depthwise route for the grouped 3×3 convs with groups == in_chan (stride 1
# or 2, any channel multiplier): "plain" (library conv) or "kernel"
# (ops/depthwise.py depthwise3x3; mds_tpu/models/layers.py:162-172's
# "pallas"). The kernel computes the conv only and has no backward.
_DEPTHWISE_IMPL = "plain"


def set_depthwise_impl(impl: str) -> None:
    if impl not in ("plain", "kernel"):
        raise ValueError(f"depthwise impl must be 'plain' or 'kernel', got {impl!r}")
    global _DEPTHWISE_IMPL
    _DEPTHWISE_IMPL = impl


# Pred tail of BiSeNetV2: "plain" (head at full resolution, then argmax) or
# "fused" (head left at its resolution, then ops/upsample_argmax.py's fused
# ×s bilinear + argmax; mds_tpu/models/layers.py:215-229).
_PRED_IMPL = "plain"


def set_pred_impl(impl: str) -> None:
    if impl not in ("plain", "fused"):
        raise ValueError(f"pred impl must be 'plain' or 'fused', got {impl!r}")
    global _PRED_IMPL
    _PRED_IMPL = impl


def get_pred_impl() -> str:
    return _PRED_IMPL


def wide(t: torch.Tensor) -> torch.Tensor:
    """t in f32, or in f64 where it is f64 (the f64 reference runs that the
    flagship's parity tests measure f32 rounding against)."""
    return t if t.dtype == torch.float64 else t.float()


def _c(v: torch.Tensor) -> torch.Tensor:
    """A per-channel vector shaped to broadcast over NCHW."""
    return v.reshape(1, -1, 1, 1)


def _global_sums(count: int, *sums: torch.Tensor) -> List[torch.Tensor]:
    """SyncBN: each per-channel sum, and this rank's element count a
    channel, summed over every rank's batch in one all_reduce
    (parallel/mesh.py global_sum: the gradient flows through the other
    ranks' shares)."""
    cnt = sums[0].new_full((1,), count)
    out = mesh.global_sum(torch.cat([*sums, cnt]))
    return [*out[:-1].split([t.numel() for t in sums]), out[-1]]


class DatasetNorm(nn.ModuleList):
    """Per-dataset BatchNorm: entry i holds dataset i's running stats (and
    its own affine when `affine`), as the reference's
    `ModuleList([BatchNorm2d] * n_bn)`. Without `affine`, the parent block
    owns a shared affine pair and passes it in as `shared=(weight, bias)`.
    BatchNorm2d's own forward is not used: it rounds elsewhere and refuses
    one value per channel, which the CEBlock's GAP BN meets in training.

    Eval: y = ((x − mean_i)·rsqrt(var_i + eps))·w + b in f32, cast to
    `dtype` (mds_tpu/models/layers.py:139-143); `fold` returns the
    equivalent per-dataset (scale, bias) (:96-115).
    Train (:126-138): the f32 batch moments over N, H, W normalize with the
    biased variance (f64 throughout in an f64 model, `wide`), and the gradient flows through them; the running stats
    move in place by momentum 0.1, the variance's with the unbiased factor
    cnt / max(cnt − 1, 1). In a SyncBN step (parallel/mesh.py) the batch is
    every rank's: the sum and the count, then the centered sum of squares,
    each summed over the ranks, and cnt is the global count."""

    momentum = 0.1

    def __init__(self, features: int, n_bn: int = 1, eps: float = 1e-5,
                 affine: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__(
            nn.BatchNorm2d(features, eps=eps, affine=affine)
            for _ in range(n_bn))
        self.eps = eps
        self.dtype = dtype

    def _affine(self, i: int, shared) -> Tuple:
        return shared if shared is not None else (self[i].weight, self[i].bias)

    def fold_at(self, i: int, shared=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dataset i's folded eval (scale, bias), f32."""
        w, b = self._affine(i, shared)
        s = torch.rsqrt(self[i].running_var.float() + self.eps) * w.float()
        return s, b.float() - self[i].running_mean.float() * s

    def fold(self, xs: MultiX, shared=None) -> Coeffs:
        return [None if x is None else self.fold_at(i, shared)
                for i, x in enumerate(xs)]

    def tensors_at(self, i: int, shared=None) -> Tuple[torch.Tensor, ...]:
        """The tensors dataset i's fold reads: affine weight and bias,
        running mean and variance."""
        return (*self._affine(i, shared), self[i].running_mean, self[i].running_var)

    def _train_norm(self, bn: nn.BatchNorm2d, x: torch.Tensor, w, b):
        xf = wide(x)
        if mesh.sync_active():
            s, cnt = _global_sums(xf.numel() // xf.shape[1], xf.sum(dim=(0, 2, 3)))
            m = s / cnt
            d = xf - _c(m)
            v = mesh.global_sum(d.square().sum(dim=(0, 2, 3))) / cnt
            unbiased = cnt / (cnt - 1).clamp_min(1)
        else:
            m = xf.mean(dim=(0, 2, 3))
            d = xf - _c(m)
            v = d.square().mean(dim=(0, 2, 3))
            cnt = x.numel() // x.shape[1]
            unbiased = cnt / max(cnt - 1, 1)
        mom = self.momentum
        with torch.no_grad():
            bn.running_mean.copy_((1 - mom) * bn.running_mean + mom * m)
            bn.running_var.copy_((1 - mom) * bn.running_var
                                 + mom * (v * unbiased))
        # the scale folds into one per-channel factor: autograd keeps one
        # f32 activation (d) per BN instead of two
        return d * _c(torch.rsqrt(v + self.eps) * wide(w)) + _c(wide(b))

    def forward(self, xs: MultiX, shared=None) -> List[Optional[torch.Tensor]]:
        if len(xs) != len(self):
            raise ValueError(f"{len(xs)} inputs for {len(self)} datasets")
        outs: List[Optional[torch.Tensor]] = []
        for i, x in enumerate(xs):
            if x is None:
                outs.append(None)
                continue
            bn = self[i]
            w, b = self._affine(i, shared)
            if self.training:
                y = self._train_norm(bn, x, w, b)
            else:
                y = (wide(x) - _c(wide(bn.running_mean))) * _c(
                    torch.rsqrt(wide(bn.running_var) + self.eps))
                y = y * _c(wide(w)) + _c(wide(b))
            outs.append(y.to(self.dtype))
        return outs


class PackCache:
    """Values derived from parameters (folded BN coefficients, weights packed
    for a kernel), kept until a tensor they came from changes. An entry is
    keyed on each source tensor's (device, data_ptr, _version): an optimizer
    step, a BN running-stat update and load_state_dict change tensors in
    place (their _version moves), .to() makes new storage; any of them
    rebuilds the entry at its next use. `builds` counts builds. A plain
    attribute of its module: not in the state dict."""

    def __init__(self):
        self._entries = {}
        self.builds = 0

    def get(self, name, tensors: Sequence[torch.Tensor], build: Callable):
        key = tuple((t.device, t.data_ptr(), t._version) for t in tensors)
        hit = self._entries.get(name)
        if hit is None or hit[0] != key:
            hit = (key, build())
            self._entries[name] = hit
            self.builds += 1
        return hit[1]


def conv_init(weight: torch.Tensor, generator: torch.Generator) -> None:
    """He/kaiming normal, fan-out — the reference's init convention
    (mds_tpu/models/layers.py:150)."""
    nn.init.kaiming_normal_(weight, mode="fan_out", nonlinearity="relu",
                            generator=generator)


def lecun_init(weight: torch.Tensor, generator: torch.Generator) -> None:
    """Normal with std 1/sqrt(fan_in): flax nn.Conv's default, for the plain
    convs that carry no BN."""
    fan_in = weight[0].numel()
    nn.init.normal_(weight, 0.0, 1.0 / math.sqrt(fan_in), generator=generator)


def conv2d(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Run a conv's geometry in the compute dtype on f32 params."""
    bias = None if conv.bias is None else conv.bias.to(dtype)
    return F.conv2d(x.to(dtype), conv.weight.to(dtype), bias, conv.stride,
                    conv.padding, conv.dilation, conv.groups)


class StemConv3x3S2(nn.Conv2d):
    """Stride-2 3×3 conv on a few-channel (RGB) input whose eval path runs
    conv → folded BN → [ReLU] in one pass: the stem kernel for a bf16
    3-channel input with even H and W (ops/stem.py stem_conv_bn_relu_s2),
    the same chain on library ops otherwise (mds_tpu/models/layers.py:319).
    Its plain conv (`conv`, the train path) under set_stem_impl("kernel")
    runs such an input through ops/stem.py stem_conv3x3_s2, kernel 1 with
    the library conv's gradients, and hands on its f32 sum as JAX's layer
    does (mds_tpu/models/layers.py:363-366); the plain switch keeps the
    library conv's bf16. The kernel's packed weight is cached (PackCache)
    until the weight changes."""

    def __init__(self, in_chan: int, out_chan: int):
        super().__init__(in_chan, out_chan, 3, stride=2, padding=1, bias=False)
        self._packs = PackCache()

    @staticmethod
    def kernel_ok(x: torch.Tensor, dtype: torch.dtype) -> bool:
        """Whether the stem kernels take x in `dtype`: bf16, 3 channels,
        even H and W."""
        return (dtype == torch.bfloat16 and x.shape[1] == 3
                and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0)

    def conv(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        x = x.to(dtype)
        if _STEM_IMPL == "kernel" and self.kernel_ok(x, dtype):
            from mds_tpu_torch.ops.stem import pack_stem, stem_conv3x3_s2

            k = self.weight.to(dtype)
            packed = self._packs.get("train", (self.weight,), lambda: pack_stem(k))
            return stem_conv3x3_s2(x.contiguous(memory_format=torch.channels_last),
                                   k, packed)
        return conv2d(self, x, dtype)

    def fused(self, x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              relu: bool, dtype: torch.dtype, packed=None) -> torch.Tensor:
        """`packed`: ops/stem.py pack_stem(weight in dtype, scale, bias) for
        the kernel, made once by the caller; packed in the call when None."""
        x = x.to(dtype)
        if self.kernel_ok(x, dtype):
            from mds_tpu_torch.ops.stem import stem_conv_bn_relu_s2

            return stem_conv_bn_relu_s2(x, self.weight.to(dtype), scale, bias, relu,
                                        packed=packed)
        y = conv2d(self, x, dtype).float() * _c(scale) + _c(bias)
        return (F.relu(y) if relu else y).to(dtype)


def bn_fold(bn: nn.BatchNorm2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """A plain BatchNorm2d's eval affine as one (scale, bias) pair in f32:
    s = γ·rsqrt(var + ε), b = β − mean·s (mds_tpu/models/layers.py:426-453
    BNFold)."""
    s = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
    return s, bn.bias.float() - bn.running_mean.float() * s


def bn_eval(bn: nn.BatchNorm2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.BatchNorm(use_running_average=not bn.training, momentum=0.9)
    in its order and rounding, out in `dtype`.

    Eval: y = (x − mean)·(rsqrt(var + ε)·γ) + β in f32 with the running
    stats. Train (flax's `_compute_stats` and `_normalize`): the f32 batch
    mean m and the fast biased variance v = max(E[x²] − m², 0) over N, H, W
    normalize, the gradient flowing through both; the running stats move in
    place to 0.9·running + 0.1·batch, the variance's with the biased v.
    BatchNorm2d's own train mode (unbiased running variance) never runs. In
    a SyncBN step (parallel/mesh.py) the sum, the sum of squares and the
    count are summed over the ranks in one all_reduce."""
    if bn.training:
        xf = x.float()
        if mesh.sync_active():
            s1, s2, cnt = _global_sums(xf.numel() // xf.shape[1], xf.sum(dim=(0, 2, 3)),
                                       xf.square().sum(dim=(0, 2, 3)))
            m = s1 / cnt
            v = torch.clamp(s2 / cnt - m.square(), min=0.0)
        else:
            m = xf.mean(dim=(0, 2, 3))
            v = torch.clamp(xf.square().mean(dim=(0, 2, 3)) - m.square(), min=0.0)
        with torch.no_grad():
            bn.running_mean.copy_(0.9 * bn.running_mean + 0.1 * m)
            bn.running_var.copy_(0.9 * bn.running_var + 0.1 * v)
        mean = m
        mul = torch.rsqrt(v + bn.eps) * bn.weight.float()
    else:
        mean = bn.running_mean.float()
        mul = torch.rsqrt(bn.running_var.float() + bn.eps) * bn.weight.float()
    y = (x.float() - _c(mean)) * _c(mul) + _c(bn.bias.float())
    return y.to(dtype)


def conv_bn_relu(conv: nn.Conv2d, bn: nn.BatchNorm2d, x: torch.Tensor,
                 dtype: torch.dtype, packs: Optional[PackCache] = None) -> torch.Tensor:
    """conv → plain single BN (bn_eval, in the BN's mode) → ReLU in
    `dtype`. A 7×7 s2 p3 conv (ResNet18's conv1, the SpatialPath's conv1)
    in eval with set_stem_impl("kernel") on a bf16 3-channel input of even
    H and W runs
    as the 7×7 stem kernel with the BN folded in (ops/stem.py
    stem7_conv_bn_relu_s2; mds_tpu/models/resnet.py:58-79 and
    bisenetv1.py:42-58, without JAX's W ≥ 512 Mosaic guard); any other
    input takes the library ops. On that route `packs`, the caller's
    PackCache, keeps the fold and the kernel's packed weight (a CUDA input's
    only) until the conv weight or a BN tensor changes; a caller without one
    gets a fresh cache, so both are made in the call."""
    if (conv.kernel_size == (7, 7) and conv.stride == (2, 2)
            and conv.padding == (3, 3) and not conv.training
            and _STEM_IMPL == "kernel" and dtype == torch.bfloat16
            and x.shape[1] == 3 and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0):
        from mds_tpu_torch.ops.stem import pack_stem7, stem7_conv_bn_relu_s2

        packs = PackCache() if packs is None else packs
        stats = (bn.weight, bn.bias, bn.running_mean, bn.running_var)
        scale, bias = packs.get("fold", stats, lambda: bn_fold(bn))
        packed = None if x.device.type == "cpu" else packs.get(
            "stem7", (conv.weight, *stats), lambda: pack_stem7(conv.weight, scale, bias))
        return stem7_conv_bn_relu_s2(x.to(dtype), conv.weight, scale, bias,
                                     packed=packed)
    return F.relu(bn_eval(bn, conv2d(conv, x, dtype), dtype))


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """Mean over H and W accumulated in f32, out in x's dtype (jnp.mean of a
    bf16 array)."""
    return x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)


def _repeat_channels(x: torch.Tensor, mult: int) -> torch.Tensor:
    """Channel c → channels c·mult … c·mult + mult − 1, channels_last out."""
    return x.permute(0, 2, 3, 1).repeat_interleave(mult, dim=3).permute(0, 3, 1, 2)


class ConvBNReLU(nn.Module):
    """conv → per-dataset BN → shared (or per-dataset) affine → ReLU
    (mds_tpu/models/layers.py:468). One conv, shared weights, applied to each
    dataset's tensor. With set_depthwise_impl("kernel") a 3×3 conv with
    groups == in_chan at stride 1 or 2 runs as the depthwise kernel
    (ops/depthwise.py; layers.py:506-512's condition), which refuses inputs
    that require grad; its weight in the compute dtype is cached (PackCache)
    under no_grad. Otherwise a grouped conv with a channel multiplier
    (groups == in_chan < out_chan) runs as the input's channels repeated
    `mult` times followed by a depthwise conv on the same (out, 1, k, k)
    weight: PyTorch launches one kernel per group for the grouped form.
    With set_conv3_eval_impl("kernel"), in eval, a plain 3×3 stride-1 conv
    with C_in <= 64 folds its BN per dataset, as JAX's Conv3x3S1Fusable
    does (layers.py:519-524, :554-559, :384-423): a dataset's input in bf16
    with H >= 512 runs ops/conv3x3.py's kernel (without JAX's TPU-backend
    test), any other input the library conv in the compute dtype then
    ·scale + bias in f32. The kernel also needs C_out % 8 == 0 (wgmma's N),
    where JAX's takes any C_out. The folded coefficients and the kernel's
    packed weight are cached (PackCache) until a parameter they came from
    changes; one pack serves every dataset (the kernel's weight is
    unscaled)."""

    def __init__(self, in_chan: int, out_chan: int, ks: int = 3,
                 stride: int = 1, groups: int = 1, n_bn: int = 1,
                 relu: bool = True, shared_affine: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if groups == 1 and ks == 3 and stride == 2 and in_chan <= 4:
            self.conv = StemConv3x3S2(in_chan, out_chan)
        else:
            self.conv = nn.Conv2d(in_chan, out_chan, ks, stride,
                                  padding=ks // 2, groups=groups, bias=False)
        self.bn = DatasetNorm(out_chan, n_bn, affine=not shared_affine,
                              dtype=dtype)
        if shared_affine:
            self.affine_weight = nn.Parameter(torch.ones(out_chan))
            self.affine_bias = nn.Parameter(torch.zeros(out_chan))
        self.shared_affine = shared_affine
        self.relu = relu
        self.dtype = dtype
        self._packs = PackCache()

    def _shared(self):
        return (self.affine_weight, self.affine_bias) if self.shared_affine else None

    def fold(self, xs: MultiX) -> Coeffs:
        return self.bn.fold(xs, self._shared())

    def folded(self, xs: MultiX) -> Tuple[torch.Tensor, Coeffs]:
        """The `emit="folded"` counterpart: the raw conv weight and the
        per-dataset folded (scale, bias), for the fused kernels."""
        return self.conv.weight, self.fold(xs)

    def fold_cached(self, i: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Dataset i's folded (scale, bias), computed once per parameter
        version."""
        shared = self._shared()
        return self._packs.get(("fold", i), self.bn.tensors_at(i, shared),
                               lambda: self.bn.fold_at(i, shared))

    def _conv(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        if (_DEPTHWISE_IMPL == "kernel" and conv.groups == conv.in_channels
                and conv.kernel_size == (3, 3) and conv.stride in ((1, 1), (2, 2))):
            from mds_tpu_torch.ops.depthwise import depthwise3x3

            x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
            # the weight in the compute dtype, cast once per parameter version
            # (under grad the wrapper must see the weight itself, and refuse it)
            w = (conv.weight.to(self.dtype) if torch.is_grad_enabled() else
                 self._packs.get("dw", (conv.weight,),
                                 lambda: conv.weight.to(self.dtype).contiguous()))
            return depthwise3x3(x, w, conv.stride[0])
        if conv.groups == conv.in_channels < conv.out_channels:
            x = _repeat_channels(x.to(self.dtype),
                                 conv.out_channels // conv.in_channels)
            return F.conv2d(x, conv.weight.to(self.dtype), None, conv.stride,
                            conv.padding, conv.dilation, conv.out_channels)
        if isinstance(conv, StemConv3x3S2):
            return conv.conv(x, self.dtype)
        return conv2d(conv, x, self.dtype)

    def _stem(self, x: torch.Tensor, i: int) -> torch.Tensor:
        """The eval stem route for dataset i: the fused stem, its folded BN
        and (for an input the kernel takes) its packed table cached per
        parameter version. A CPU tensor runs the plain version, which reads
        no table; it is packed all the same, once per version."""
        scale, bias = self.fold_cached(i)
        packed = None
        if self.conv.kernel_ok(x, self.dtype):
            from mds_tpu_torch.ops.stem import pack_stem

            k = self.conv.weight
            srcs = (k, *self.bn.tensors_at(i, self._shared()))
            packed = self._packs.get(("stem", i), srcs,
                                     lambda: pack_stem(k.to(self.dtype), scale, bias))
        return self.conv.fused(x, scale, bias, self.relu, self.dtype, packed)

    def _conv3_fusable(self) -> bool:
        """The conv3 route's module condition: eval, a plain 3×3 s1 conv,
        C_in <= 64."""
        conv = self.conv
        return (_CONV3_EVAL_IMPL == "kernel" and not self.training
                and type(conv) is nn.Conv2d and conv.groups == 1
                and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
                and conv.dilation == (1, 1) and conv.bias is None
                and conv.in_channels <= 64)

    def _conv3_route(self, x: torch.Tensor) -> bool:
        """Whether this dataset's input runs the conv3 kernel: bf16 and
        H >= 512 (JAX's test), C_out % 8 == 0 (the port's own)."""
        return (self.dtype == torch.bfloat16 and x.shape[2] >= 512
                and self.conv.out_channels % 8 == 0)

    def _conv3(self, x: torch.Tensor, i: int) -> torch.Tensor:
        scale, bias = self.fold_cached(i)
        if self._conv3_route(x):
            from mds_tpu_torch.ops.conv3x3 import conv3x3_bn_relu, pack_conv3x3

            k = self.conv.weight
            wp = None if x.device.type == "cpu" else self._packs.get(
                "conv3x3", (k,), lambda: pack_conv3x3(k))
            return conv3x3_bn_relu(
                x.to(self.dtype).contiguous(memory_format=torch.channels_last),
                k, scale, bias, self.relu, wp)
        y = conv2d(self.conv, x, self.dtype).float() * _c(scale) + _c(bias)
        return (F.relu(y) if self.relu else y).to(self.dtype)

    def forward(self, xs: MultiX) -> List[Optional[torch.Tensor]]:
        if (not self.training and isinstance(self.conv, StemConv3x3S2)
                and _STEM_IMPL == "kernel"):
            return [None if x is None else self._stem(x, i)
                    for i, x in enumerate(xs)]
        if self._conv3_fusable():
            return [None if x is None else self._conv3(x, i)
                    for i, x in enumerate(xs)]
        xs = lmap(self._conv, xs)
        xs = self.bn(xs, self._shared())
        return lmap(F.relu, xs) if self.relu else xs


def ConvBN(*args, **kw) -> ConvBNReLU:
    """ConvBNReLU without the ReLU (mds_tpu/models/layers.py:567)."""
    return ConvBNReLU(*args, relu=False, **kw)


def upsample(x: torch.Tensor, factor: int, method: str = "nearest") -> torch.Tensor:
    """Integer-factor spatial upsample: 'nearest', or 'bilinear' with
    align_corners=False (half-pixel), computed in f32."""
    h, w = x.shape[-2:]
    if method == "nearest":
        return F.interpolate(x, size=(h * factor, w * factor), mode="nearest")
    out = F.interpolate(x.float(), size=(h * factor, w * factor),
                        mode="bilinear", align_corners=False)
    return out.to(x.dtype)


def resize_bilinear(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize to a target size (align_corners=False), in f32, cast
    back: jax.image.resize(..., "linear"), whose upsample is half-pixel
    bilinear with the edges clamped; a shrinking axis is antialiased as
    jax.image.resize does."""
    h, w = x.shape[-2:]
    out = F.interpolate(wide(x), size=tuple(size_hw), mode="bilinear",
                        align_corners=False,
                        antialias=size_hw[0] < h or size_hw[1] < w)
    return out.to(x.dtype)


def resize_bilinear_ac(x: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with align_corners=True of an NCHW tensor, on an f32
    copy; x itself when it already has the size
    (mds_tpu/models/layers.py:573-602)."""
    if tuple(x.shape[-2:]) == tuple(size_hw):
        return x
    return F.interpolate(wide(x), size=tuple(size_hw), mode="bilinear",
                         align_corners=True)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 3, 2, 1)


def avg_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """AvgPool2d(3, stride=2, padding=1) with count_include_pad=True.

    Under autograd the pool runs on an NCHW-contiguous copy: PyTorch's CUDA
    backward of avg_pool2d on a channels_last input returns a wrong gradient
    (relative L2 error 1.04 against the CPU's, torch 2.11.0+cu128 on an
    NVIDIA H100; chip_smoke.py's parity phase measures it on every run and
    says when this copy can go)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return F.avg_pool2d(x.contiguous(), 3, 2, 1, count_include_pad=True
                            ).contiguous(memory_format=torch.channels_last)
    return F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)


class FastDropout(nn.Module):
    """Dropout with a uint8 keep threshold (mds_tpu/models/layers.py:736):
    keep ⇔ the top 8 bits of a random u32 ≥ round(rate·256), kept values
    scaled by 256/(256 − drop). The mask comes from the dropout op
    (ops/dropout.py: the CUDA kernel on the card), its seed from the
    `generator` passed in; identity in eval or at rate 0. `rate` is a plain
    attribute, so a test can set it to 0. In a data-parallel step
    (parallel/mesh.py) rank r's x is rows r of the global batch and draws
    from element r · x.numel() of the mask: the ranks' masks are the rows of
    the one-process mask of the whole batch."""

    def __init__(self, rate: float = 0.1):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training or self.rate == 0.0:
            return x
        # the mask follows storage order: pin it to channels_last so the
        # same seed drops the same elements on every device
        return dropout(x.contiguous(memory_format=torch.channels_last),
                       self.rate, generator, offset=mesh.shard_index() * x.numel())


class SegmentHead(nn.Module):
    """Per-dataset segmentation head (mds_tpu/models/layers.py:770):
    conv3×3-BN-ReLU(in→mid) → dropout(0.1) (train only) → [aux: ×2 nearest
    → conv3×3-BN-ReLU(mid→up²)] → 1×1 conv with bias → bilinear ×factor in
    the compute dtype, or left at head resolution with up=False."""

    def __init__(self, in_chan: int, mid_chan: int, n_classes: int,
                 up_factor: int = 8, aux: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = ConvBNReLU(in_chan, mid_chan, 3, dtype=dtype)
        self.drop = FastDropout(0.1)
        out_in = mid_chan
        if aux:
            out_in = up_factor * up_factor
            self.conv1 = ConvBNReLU(mid_chan, out_in, 3, dtype=dtype)
        self.conv2 = nn.Conv2d(out_in, n_classes, 1, bias=True)
        self.up_factor = up_factor
        self.aux = aux
        self.dtype = dtype

    @property
    def residual_factor(self) -> int:
        """Upsample factor still owed when called with up=False."""
        return self.up_factor // 2 if self.aux else self.up_factor

    def forward(self, x: torch.Tensor, up: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        (x,) = self.conv([x])
        x = self.drop(x, generator)
        if self.aux:
            (x,) = self.conv1([upsample(x, 2, "nearest")])
        x = conv2d(self.conv2, x, self.dtype)
        factor = self.residual_factor
        if up and factor > 1:
            h, w = x.shape[-2:]
            x = F.interpolate(x, size=(h * factor, w * factor),
                              mode="bilinear", align_corners=False)
        return x
