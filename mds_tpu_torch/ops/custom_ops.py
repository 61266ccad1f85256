"""The kernels a served artifact reaches, as PyTorch custom ops.

`torch.export` cannot follow a wrapper into its kernel: the wrapper hands
raw pointers to ctypes (ops/stem.py `_ptr`, `_stream`), which a fake
tensor has none of, and a trace of the CPU route would inline the plain
version. So each wrapper, while `torch.compiler.is_compiling()` (an export
or a compile is tracing), calls its op here instead, and the graph keeps
one `mds_tpu_torch::<name>` node per kernel call:

  mds_tpu_torch::stem_conv_bn_relu_s2   kernel 1 (ops/stem.py)
  mds_tpu_torch::detail_s1s2_fused      kernel 4 (ops/stem.py)
  mds_tpu_torch::stemblock_fused        kernel 5 (ops/stem.py)
  mds_tpu_torch::stem7_conv_bn_relu_s2  kernel 6 (ops/stem.py)
  mds_tpu_torch::detail_tail_fused      kernel 7 (ops/stem.py)
  mds_tpu_torch::depthwise3x3           kernel 9 (ops/depthwise.py)
  mds_tpu_torch::upsample_argmax        kernel 11 (ops/upsample_argmax.py)

An op's body is its wrapper, called when the graph runs: a CUDA tensor
launches the kernel (and counts the launch on `<wrapper>.launches`), a CPU
tensor runs the plain version. Its fake returns the kernel's output layout
(channels_last feature maps; a contiguous int32 label map), which the
traced code after it is specialised on. The fused kernels take their
parameters as one list (`params`, the wrapper's positional arguments after
the input) and their packed weights as another (`packed`, empty where the
caller packs nothing: a CPU input's plain version reads none). Eager calls
go to the wrappers directly, without the dispatcher's cost. Importing this
module registers the ops (deploy/export.py imports it before it loads an
artifact); the kernel library is still built at the first launch.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import Tensor

from mds_tpu_torch.ops import depthwise as _dw
from mds_tpu_torch.ops import stem as _stem
from mds_tpu_torch.ops import upsample_argmax as _ua

_CL = torch.channels_last


def _feature(x: Tensor, c: int, h: int, w: int, dtype=None) -> Tensor:
    """An empty (B, c, h, w) channels_last map on x's device."""
    return torch.empty((x.shape[0], c, h, w), dtype=dtype or x.dtype, device=x.device,
                       memory_format=_CL)


def _packed(packed: List[Tensor]):
    return tuple(packed) or None


@torch.library.custom_op("mds_tpu_torch::stem_conv_bn_relu_s2", mutates_args=())
def stem_conv_bn_relu_s2(x: Tensor, k: Tensor, scale: Tensor, bias: Tensor, relu: bool,
                         packed: Optional[Tensor]) -> Tensor:
    return _stem.stem_conv_bn_relu_s2(x, k, scale, bias, relu, packed)


@stem_conv_bn_relu_s2.register_fake
def _(x, k, scale, bias, relu, packed):
    return _feature(x, k.shape[0], x.shape[2] // 2, x.shape[3] // 2, torch.bfloat16)


@torch.library.custom_op("mds_tpu_torch::detail_s1s2_fused", mutates_args=())
def detail_s1s2_fused(x: Tensor, params: List[Tensor], packed: List[Tensor]) -> Tensor:
    return _stem.detail_s1s2_fused(x, *params, packed=_packed(packed))


@detail_s1s2_fused.register_fake
def _(x, params, packed):
    return _feature(x, 64, x.shape[2] // 4, x.shape[3] // 4, torch.bfloat16)


@torch.library.custom_op("mds_tpu_torch::stemblock_fused", mutates_args=())
def stemblock_fused(x: Tensor, params: List[Tensor], packed: List[Tensor]) -> Tensor:
    return _stem.stemblock_fused(x, *params, packed=_packed(packed))


@stemblock_fused.register_fake
def _(x, params, packed):
    return _feature(x, 16, x.shape[2] // 4, x.shape[3] // 4, torch.bfloat16)


@torch.library.custom_op("mds_tpu_torch::stem7_conv_bn_relu_s2", mutates_args=())
def stem7_conv_bn_relu_s2(x: Tensor, k: Tensor, scale: Tensor, bias: Tensor, relu: bool,
                          packed: Optional[Tensor]) -> Tensor:
    return _stem.stem7_conv_bn_relu_s2(x, k, scale, bias, relu, packed)


@stem7_conv_bn_relu_s2.register_fake
def _(x, k, scale, bias, relu, packed):
    return _feature(x, k.shape[0], x.shape[2] // 2, x.shape[3] // 2, torch.bfloat16)


@torch.library.custom_op("mds_tpu_torch::detail_tail_fused", mutates_args=())
def detail_tail_fused(y: Tensor, params: List[Tensor], packed: List[Tensor]) -> Tensor:
    return _stem.detail_tail_fused(y, *params, packed=_packed(packed))


@detail_tail_fused.register_fake
def _(y, params, packed):
    return _feature(y, 128, y.shape[2] // 2, y.shape[3] // 2, torch.bfloat16)


@torch.library.custom_op("mds_tpu_torch::depthwise3x3", mutates_args=())
def depthwise3x3(x: Tensor, w: Tensor, stride: int) -> Tensor:
    return _dw.depthwise3x3(x, w, stride)


@depthwise3x3.register_fake
def _(x, w, stride):
    return _feature(x, w.shape[0], -(-x.shape[2] // stride), -(-x.shape[3] // stride))


@torch.library.custom_op("mds_tpu_torch::upsample_argmax", mutates_args=())
def upsample_argmax(logits: Tensor, scale: int) -> Tensor:
    return _ua.upsample_argmax(logits, scale).contiguous()


@upsample_argmax.register_fake
def _(logits, scale):
    b, _, h, w = logits.shape
    return torch.empty((b, h * scale, w * scale), dtype=torch.int32, device=logits.device)


# each op's wrapper, by op name: its `launches` counts the op's kernel launches
KERNELS = {"stem_conv_bn_relu_s2": _stem.stem_conv_bn_relu_s2,
           "detail_s1s2_fused": _stem.detail_s1s2_fused,
           "stemblock_fused": _stem.stemblock_fused,
           "stem7_conv_bn_relu_s2": _stem.stem7_conv_bn_relu_s2,
           "detail_tail_fused": _stem.detail_tail_fused,
           "depthwise3x3": _dw.depthwise3x3,
           "upsample_argmax": _ua.upsample_argmax}
