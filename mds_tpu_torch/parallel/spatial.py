"""Spatially parallel inference — counterpart of mds_tpu/parallel/spatial.py
(`plan_tiles` :28, `halo_conv3x3` :43, `tiled_inference` :87).

A frame is cut along W into overlapping tiles, each a center and a context
margin on both sides; the tiles run as a batch and their centers are
stitched back. JAX shards the tile batch over its mesh; here rank r of the
process group runs tiles r, r + world, ..., and one process runs them all
as one batch. The margin plays the halo's role: BiSeNetV2's receptive
field is bounded, so the tiled logits match the whole frame's but for its
global-pool paths (the CEBlock sees a tile's context), the approximation
every sliding-window evaluator makes. `halo_conv3x3` is the exact
primitive: a 3×3 conv on a W-sharded tensor whose edge columns come from
the neighbouring ranks.

Tensors are NCHW (the port's convention; JAX's are NHWC). The exchanges are
all_reduces of zero buffers in which each rank fills its own slot: the
slots are disjoint, so the sums are exact.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch
import torch.nn.functional as F

from mds_tpu_torch.parallel import mesh


def plan_tiles(size: int, n_tiles: int, margin: int,
               multiple: int = 32) -> Tuple[int, List[Tuple[int, int, int]]]:
    """Split `size` into n_tiles center-regions with symmetric margins.
    Returns (tile_extent, [(src_start, center_start, center_len)])."""
    center = -(-size // n_tiles)
    extent = center + 2 * margin
    extent = -(-extent // multiple) * multiple
    plans = []
    for i in range(n_tiles):
        c0 = i * center
        clen = min(center, size - c0)
        src = min(max(c0 - margin, 0), max(size - extent, 0))
        plans.append((src, c0, clen))
    return extent, plans


def halo_conv3x3(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """3×3, stride 1, padding 1 conv of this rank's W-shard x (B, C, H, w)
    of a tensor split along W over the ranks in rank order, with weight
    (O, C, 3, 3): this rank's shard of the unsharded conv. The shards'
    first and last columns go through one all_reduce of a zero (world, 2,
    B, C, H) buffer; the image border's halos are zeros."""
    w, r = mesh.world(), mesh.rank()
    cols = torch.zeros((w, 2, *x.shape[:3]), dtype=x.dtype, device=x.device)
    cols[r, 0], cols[r, 1] = x[..., 0], x[..., -1]
    cols = mesh.all_reduce(cols)
    zero = torch.zeros_like(x[..., :1])
    left = cols[r - 1, 1].unsqueeze(-1) if r > 0 else zero
    right = cols[r + 1, 0].unsqueeze(-1) if r < w - 1 else zero
    return F.conv2d(torch.cat([left, x, right], dim=3), weight, padding=(1, 0))


def tiled_inference(logits_fn: Callable, im: torch.Tensor, n_classes: int,
                    n_tiles: Optional[int] = None, margin: int = 96,
                    dataset: int = 0) -> torch.Tensor:
    """im (1, C, H, W) → (1, n_classes, H', W') f32 logits: `n_tiles` (the
    world size by default, as JAX's tile count is its mesh's) W tiles of
    `plan_tiles(W, n_tiles, margin)`, this rank's run by
    logits_fn(tiles, dataset) as one batch, each center written into a zero
    output, the outputs summed over the ranks. Every rank returns the whole
    frame's logits."""
    w, r = mesh.world(), mesh.rank()
    n_tiles = w if n_tiles is None else n_tiles
    if n_tiles < w:
        raise ValueError(f"{n_tiles} tiles for {w} ranks: every rank needs a tile")
    wd = im.shape[-1]
    extent, plans = plan_tiles(wd, n_tiles, margin)
    if extent > wd:
        raise ValueError(f"a tile of {extent} columns exceeds the frame's {wd}")
    mine = plans[r::w]
    logits = logits_fn(torch.cat([im[..., src:src + extent] for src, _, _ in mine]), dataset)
    scale_w = logits.shape[3] / extent
    out = torch.zeros((1, n_classes, logits.shape[2], int(round(wd * scale_w))),
                      dtype=torch.float32, device=logits.device)
    for j, (src, c0, clen) in enumerate(mine):
        off, cl = int(round((c0 - src) * scale_w)), int(round(clen * scale_w))
        o0 = int(round(c0 * scale_w))
        out[..., o0:o0 + cl] = logits[j, :, :, off:off + cl].float()
    return mesh.all_reduce(out)
