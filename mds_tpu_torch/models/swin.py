"""Swin-T and BiSeNetV1-Swin in PyTorch — counterpart of mds_tpu/models/swin.py
(`window_partition` :36, `window_reverse` :43, `relative_position_index`
:49, `WindowAttention` :60, `shift_attn_mask` :101, `SwinBlock` :115,
`PatchMerging` :149, `SwinTransformer` :166, `BiSeNetV1Swin` :207-264).

- Swin-T: a 4×4 stride-4 patch embedding with bias (no padding: H and W
  are multiples of 4), then 4 stages of window-attention blocks (depths 2,
  2, 6, 2; heads 3, 6, 12, 24; window 7; every second block shifted by 3)
  with a PatchMerging between stages; stages 1-3 each go through a
  LayerNorm of their own (`out_norm{1,2,3}`) and come out as the features
  at 1/8, 1/16 and 1/32 (192, 384, 768 channels). H and W must be
  multiples of 7·32 = 224, as in JAX, which pads nothing.
- Tokens run NHWC inside the trunk (the LayerNorms and Linears act on the
  channel axis); the features come out NCHW, stored channels_last.
- Numerics as JAX's: every LayerNorm is flax's (epsilon 1e-6, the f32
  mean and the fast variance E[x²] − E[x]², clipped at 0, out in the
  compute dtype); the attention's q·kᵀ and attn·v take their operands in
  the compute dtype and sum in f32, the relative-position bias from the
  (2·ws − 1)² table and the −100 shift mask are added in f32 and the
  softmax is taken in f32, then cast; the GELU is exact (erf); the cyclic
  shift is torch.roll by (−s, −s) and back.
- PatchMerging concatenates the 2×2 quadrants in the order (even row, even
  col), (odd, even), (even, odd), (odd, odd), as the reference's
  cat([x0, x1, x2, x3]) (swin.py:156-160).
- Names are the reference layout (`patch_embed.{proj,norm}`,
  `layers.{s}.blocks.{b}.{norm1,attn.{qkv,proj,relative_position_bias_table},
  norm2,mlp.{fc1,fc2}}`, `layers.{s}.downsample.{norm,reduction}`) but the
  output norms, `out_norm{s}` for the reference's `norm{s}`
  (deploy/weights.py `swin_from_torch`).
- BiSeNetV1Swin: BiSeNetV1 (models/bisenetv1.py) whose context path reads
  the Swin features: ARMs at 768 and 384 channels, the global context of
  the 1/32 feature, the SpatialPath, the FFM and the heads. Its
  SpatialPath.conv1, the 7×7 s2 RGB conv, runs kernel 6
  (stem7_conv_bn_relu_s2) once a frame on the stem route in eval.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mds_tpu_torch.models.bisenetv1 import (
    AttentionRefinementModule,
    BiSeNetOutput,
    ConvBNReLU1,
    FeatureFusionModule,
    SpatialPath,
)
from mds_tpu_torch.models.layers import (
    conv2d,
    conv_init,
    global_avg_pool,
    lecun_init,
    upsample,
    wide,
)
from mds_tpu_torch.models.semseg import _trunc_normal
from mds_tpu_torch.registry import MODELS

LN_EPS = 1e-6  # flax nn.LayerNorm's default epsilon


def window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, ws, ws, C), windows in row-major order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c)


def window_reverse(windows: torch.Tensor, ws: int, h: int, w: int) -> torch.Tensor:
    """(B·nW, ws, ws, C) → (B, H, W, C)."""
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, -1)


def relative_position_index(ws: int) -> torch.Tensor:
    """(ws², ws²) int64: each token pair's row in the (2·ws − 1)² bias
    table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return torch.from_numpy(rel.sum(-1).astype(np.int64))


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> torch.Tensor:
    """(nW, ws², ws²) f32: −100 between tokens of a shifted window that
    come from different regions of the image, 0 elsewhere."""
    img = np.zeros((1, h, w, 1), np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, hs, wsl, :] = cnt
            cnt += 1
    mw = img.reshape(1, h // ws, ws, w // ws, ws, 1)
    mw = mw.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = mw[:, None, :] - mw[:, :, None]
    return torch.from_numpy(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.LayerNorm over the last axis in its order and rounding: the
    mean and the fast variance in f32, (x − m)·(rsqrt(v + ε)·γ) + β, out in
    `dtype`."""
    xf = wide(x)
    m = xf.mean(dim=-1, keepdim=True)
    v = torch.clamp(xf.square().mean(dim=-1, keepdim=True) - m.square(), min=0.0)
    y = (xf - m) * (torch.rsqrt(v + norm.eps) * wide(norm.weight)) + wide(norm.bias)
    return y.to(dtype)


def linear(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax nn.Dense(dtype=dtype) on f32 params: the product and the bias
    in the compute dtype."""
    bias = None if lin.bias is None else lin.bias.to(dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), bias)


class WindowAttention(nn.Module):
    """Multi-head self-attention within a window, with the relative
    position bias (swin.py:60-98)."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index",
                             relative_position_index(window_size).reshape(-1),
                             persistent=False)
        self.window_size, self.num_heads, self.dtype = window_size, num_heads, dtype

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        B_, N, C = x.shape
        nh = self.num_heads
        hd = C // nh
        qkv = linear(self.qkv, x, self.dtype).reshape(B_, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * hd ** -0.5, qkv[1], qkv[2]
        attn = torch.matmul(wide(q), wide(k).transpose(-2, -1))
        bias = self.relative_position_bias_table[self.relative_position_index]
        attn = attn + wide(bias).reshape(N, N, nh).permute(2, 0, 1)[None]
        if mask is not None:
            nW = mask.shape[0]
            attn = (attn.reshape(B_ // nW, nW, nh, N, N) + mask[None, :, None]
                    ).reshape(-1, nh, N, N)
        attn = torch.softmax(attn, dim=-1).to(self.dtype)
        out = torch.matmul(wide(attn), wide(v)).to(self.dtype)
        return linear(self.proj, out.transpose(1, 2).reshape(B_, N, C), self.dtype)


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)


class SwinBlock(nn.Module):
    """LN → (shifted) window attention → residual; LN → MLP (exact GELU) →
    residual (swin.py:115-146). Tokens (B, H, W, C)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttention(dim, window_size, num_heads, dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.window_size, self.shift, self.dtype = window_size, shift, dtype
        self._masks: Dict = {}

    def attn_mask(self, h: int, w: int, device) -> torch.Tensor:
        key = (h, w, str(device))
        if key not in self._masks:
            self._masks[key] = shift_attn_mask(h, w, self.window_size, self.shift).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        ws, s = self.window_size, self.shift
        y = layer_norm(self.norm1, x, self.dtype)
        mask = None
        if s > 0:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
            mask = self.attn_mask(h, w, x.device)
        y = self.attn(window_partition(y, ws).reshape(-1, ws * ws, c), mask)
        y = window_reverse(y.reshape(-1, ws, ws, c), ws, h, w)
        if s > 0:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = x + y
        y = linear(self.mlp.fc1, layer_norm(self.norm2, x, self.dtype), self.dtype)
        return x + linear(self.mlp.fc2, F.gelu(y), self.dtype)


class PatchMerging(nn.Module):
    """2×2 quadrants concatenated → LN over 4C → Linear to 2C without bias
    (swin.py:149-163)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim, eps=LN_EPS)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        x = x.reshape(b, h // 2, w // 2, 4 * c)
        return linear(self.reduction, layer_norm(self.norm, x, self.dtype), self.dtype)


class PatchEmbed(nn.Module):
    def __init__(self, embed_dim: int, patch: int = 4):
        super().__init__()
        self.proj = nn.Conv2d(3, embed_dim, patch, patch)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)


class SwinStage(nn.Module):
    def __init__(self, blocks, downsample: Optional[nn.Module]):
        super().__init__()
        self.blocks = nn.ModuleList(blocks)
        self.downsample = downsample


class SwinTransformer(nn.Module):
    """Swin-T trunk (swin.py:166-204): an NCHW input → the (feat8, feat16,
    feat32) features, NCHW channels_last in the compute dtype."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.patch_embed = PatchEmbed(embed_dim)
        stages, dim = [], embed_dim
        for si, (depth, heads) in enumerate(zip(depths, num_heads)):
            blocks = [SwinBlock(dim, heads, window_size, 0 if bi % 2 == 0 else window_size // 2,
                                dtype=dtype) for bi in range(depth)]
            last = si == len(depths) - 1
            stages.append(SwinStage(blocks, None if last else PatchMerging(dim, dtype)))
            if si > 0:
                setattr(self, f"out_norm{si}", nn.LayerNorm(dim, eps=LN_EPS))
            dim *= 1 if last else 2
        self.layers = nn.ModuleList(stages)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        x = conv2d(self.patch_embed.proj, x, self.dtype).permute(0, 2, 3, 1)
        x = layer_norm(self.patch_embed.norm, x, self.dtype)
        feats = []
        for si, stage in enumerate(self.layers):
            for blk in stage.blocks:
                x = blk(x)
            if si > 0:
                feats.append(layer_norm(getattr(self, f"out_norm{si}"), x, self.dtype)
                             .permute(0, 3, 1, 2))
            if stage.downsample is not None:
                x = stage.downsample(x)
        return tuple(feats)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "SwinTransformer":
        """flax's defaults: lecun normal kernels and zero biases for the
        Linears and the patch embedding, unit LayerNorms, truncated
        normal(0.02) bias tables."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Conv2d)):
                lecun_init(m.weight, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
            elif isinstance(m, WindowAttention):
                _trunc_normal(m.relative_position_bias_table, 0.02, generator)
        return self


@MODELS.register("bisenetv1_swin")
class BiSeNetV1Swin(nn.Module):
    """BiSeNetV1 with a Swin-T context path (swin.py:207-264; JAX's
    constructor: `n_classes`, `aux`, `dtype`). Single-dataset; inputs
    (B, 3, H, W) with H and W multiples of 224."""

    def __init__(self, n_classes: Sequence[int] = (19,), aux: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        n = n_classes[0]
        self.swin = SwinTransformer(dtype=dtype)
        self.arm16 = AttentionRefinementModule(384, 128, dtype)
        self.arm32 = AttentionRefinementModule(768, 128, dtype)
        self.conv_head32 = ConvBNReLU1(128, 128, 3, dtype=dtype)
        self.conv_head16 = ConvBNReLU1(128, 128, 3, dtype=dtype)
        self.conv_avg = ConvBNReLU1(768, 128, 1, padding=0, dtype=dtype)
        self.sp = SpatialPath(dtype)
        self.ffm = FeatureFusionModule(256, 256, dtype)
        self.conv_out = BiSeNetOutput(256, 256, n, up_factor=8, dtype=dtype)
        if aux:
            self.conv_out16 = BiSeNetOutput(128, 64, n, up_factor=8, dtype=dtype)
            self.conv_out32 = BiSeNetOutput(128, 64, n, up_factor=16, dtype=dtype)
        self.n_classes = tuple(n_classes)
        self.n_bn = 1
        self.aux = aux
        self.dtype = dtype

    def _context(self, x: torch.Tensor):
        _, feat16, feat32 = self.swin(x)
        avg = self.conv_avg(global_avg_pool(feat32))
        f32_up = self.conv_head32(upsample(self.arm32(feat32) + avg, 2))
        f16_up = self.conv_head16(upsample(self.arm16(feat16) + f32_up, 2))
        return f16_up, f32_up

    def _features(self, x: torch.Tensor):
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        feat_cp8, feat_cp16 = self._context(x)
        return self.ffm(self.sp(x), feat_cp8), feat_cp8, feat_cp16

    def forward(self, xs, up: bool = True,
                generator: Optional[torch.Generator] = None) -> Dict:
        """The list-form call (swin.py:242-254): "logits" the main head's
        and, in train mode with aux heads, "aux" as [[x8 head], [x16
        head]]; `generator` for the trainers' common call (no dropout)."""
        x = xs[0] if isinstance(xs, (list, tuple)) else xs
        feat, feat_cp8, feat_cp16 = self._features(x)
        out = {"logits": [self.conv_out(feat, up)]}
        if self.aux and self.training:
            out["aux"] = [[self.conv_out16(feat_cp8, up)], [self.conv_out32(feat_cp16, up)]]
        return out

    def eval_logits(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        """Main logits (B, C, H, W) in f32 at input resolution."""
        return self.conv_out(self._features(x)[0])

    def pred(self, x: torch.Tensor, dataset: int = 0) -> torch.Tensor:
        return self.eval_logits(x, dataset).argmax(dim=1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "BiSeNetV1Swin":
        """The Swin trunk's flax defaults; kaiming fan-out for the convs
        followed by a BN, lecun normal for the ARM and FFM attention convs
        and the heads' conv_out, zero biases."""
        self.swin.init_weights(generator)
        plain = [self.ffm.conv, self.arm16.conv_atten, self.arm32.conv_atten]
        plain += [m.conv_out for m in self.modules() if isinstance(m, BiSeNetOutput)]
        for name, m in self.named_modules():
            if isinstance(m, nn.Conv2d) and not name.startswith("swin."):
                if any(m is p for p in plain):
                    lecun_init(m.weight, generator)
                    if m.bias is not None:
                        m.bias.zero_()
                else:
                    conv_init(m.weight, generator)
        return self
