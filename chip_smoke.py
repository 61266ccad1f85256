#!/usr/bin/env python
"""Drive the PyTorch port's serving paths and train step once on one CUDA card.

  python3 chip_smoke.py

Phases, one JSON line each; any failure raises, so the script exits non-zero
before the last line:

1. device   — needs torch.cuda; the card's name and power limit.
2. build    — nvcc builds mds_tpu_torch/csrc/*.cu for sm_90a, one process
              per source; cuobjdump's SASS of the library must show HGMMA
              (warpgroup MMA) and no HMMA (mma.sync) in the conv3,
              detail-tail, S1-pair (kernel 3), detail-head (4), 3×3 stem
              (kernels 1 and 2), StemBlock (5) and 7×7 stem (6) kernels.
3. kernels  — each stem kernel at the serving shapes (B=1, 1024×2048; the
              7×7 stem of BiSeNetV1 at O=64; the single 3×3 stem and its
              window variant at O=64 and 16, the window variant bit-equal
              to the single stem, both with a bit-equal share >= 0.999 and
              timed warm on their packed table, cold packing in the call
              and by the profiler's device time) against its plain PyTorch
              version on the card (TF32 off), rel max-diff < 1e-2, times as
              the median of 20 CUDA-event runs; beside the single 3×3, its
              window variant and the 7×7 stems, one bf16 F.conv2d with the
              folded weight and bias (no ReLU) as the library's time; the
              7×7 and the 3×3 stems (with the f32 training form) also on
              ragged tiles, B > 1 and O from 8 to 128, the StemBlock at B =
              2 with H/4 and W/4 off its strips and at H = W = 4; the S1
              pair (kernel 3), the fused detail head (4), the StemBlock (5)
              and the 7×7 stem (6) warm on their weights packed once (the
              warm output equal to the cold one), cold packing in the call
              and by their device time, each with its bit-equal share
              (>= 0.999 for 5 and 6 at the frame). Then the kernels of
              BiSeNetV2's routes at the inputs one served frame gives them
              (captured from the model): the 16 depthwise convs through
              depthwise3x3 (bit-equal share >= 0.999 and rel < 1e-2 against
              the plain version; each shape's device time beside that of
              the library's bf16 grouped F.conv2d), the 10 stride-1 ones
              through
              depthwise3x3_dma (also bit-equal to depthwise3x3; kernel 9's
              device time beside its own at each shape), the head
              logits (1, 19, 128, 256) through upsample_argmax (label
              agreement >= 0.9999, differing pixels and its device time
              printed), the /4 detail feature (1, 64, 256, 512)
              through detail_tail_fused, and DetailBranch S1_2's input
              (1, 64, 512, 1024) of a frame on the window-stem + conv3 route
              through conv3x3_bn_relu (both rel < 1e-2, bit-equal share
              printed; each timed cold, packing its weights, and warm, on
              the model's packed weights, and its own device time read by
              torch.profiler); beside each, the library's bf16 grouped F.conv2d
              and the port's library route, the interpolate + argmax chain,
              the plain route's five ConvBNReLU modules, or one bf16
              F.conv2d with the folded weight and bias; then the depthwise,
              upsample, S1-pair, tail and conv3 kernels on ragged shapes
              (odd tiles, B > 1, the depthwise kernel's staged form at m =
              2, 3, 4 and 6, the DMA kernel's TMA form with windows off
              every side of the image, more tiles than one persistent pass,
              B = 3 and f32, and its masked form at C % 8 != 0 -- each
              bit-equal to the plain version and to depthwise3x3 --, the
              upsample at s = 1-8 and C = 1-150 in bf16
              and f32, conv3 at C_in 3-64 and C_out 8-136).
4. dropout  — the dropout kernel at the main head's shape (16, 1024, 64,
              128) bf16 channels_last, rate 0.1: bit-identical to its plain
              version, keep fraction within 0.002 of 230/256, kept values
              scaled by bf16(256/230), masks fixed by the seed, and the
              backward's mask the forward's; torch.native_dropout at the
              same rate as the library's time.
5. slice    — BiSeNetV2 (configs/bisenetv2_city.json: 19 classes, bf16,
              seeded weights, random BN stats) behind the port's HTTP server
              on 127.0.0.1 answers 3 requests of 1024×2048 uint8 frames with
              every deploy route on (stem kernel, detail fusion and tail,
              depthwise kernel, fused pred); then one E2EModel call on the
              stem-kernel route alone and one on it with the window stem and
              the conv3 kernel. The kernel launch counts of that run are
              read (per request 16 depthwise3x3 and 1 each of
              detail_s1s2_fused, stemblock_fused, detail_tail_fused and
              upsample_argmax; 2 stem_conv_bn_relu_s2 on the stem route; 2
              stem_conv_bn_relu_s2_window and 1 conv3x3_bn_relu on the
              window-stem + conv3 route), and the label maps are held
              against the same model on the plain path (library ops): the
              served ones against its head logits put through the fused
              tail's plain version, the stem routes' against its labels,
              agreement > 0.995; logits rel max-diff < 2e-2 on every route.
              E2EModel time per frame on all routes, all routes but the
              tail, the fused stem routes alone (stem kernel, detail
              fusion), the stem route, the window-stem + conv3 route and the
              plain path in turns; one profiled frame on each.
6. v1_slice — BiSeNetV1 (configs/bisenetv1_city.json: 19 classes, no aux
              heads, bf16, seeded weights, random BN stats), built by
              tools/serve_torch.py's build_e2e, behind the port's HTTP
              server on 127.0.0.1 with set_stem_impl("kernel") answers 3
              requests of 1024×2048 uint8 frames: 2 stem-7 launches per
              frame and no other stem kernel's; every label map against the
              same model on the plain path (agreement > 0.995, logits rel
              < 2e-2); E2EModel time per frame with the kernel and on the
              plain path (CUDA events, median of 10, in turns); one frame
              of each route under torch.profiler (idle share, device
              launches, time by kernel, the stem kernel's device time).
7. train    — the train step (BiSeNetV2 with aux heads, bf16, the config's
              SGD and warmup-poly LR) at batch 16 of 512×1024 uint8 images:
              2 warm-up steps, 5 timed ones (CUDA events, median), finite
              losses, parameters and BN stats moved, 10 dropout launches per
              step and no stem-kernel launch (the fused routes are eval-only);
              the dropout kernel's bound for a step (its 10 calls' inputs
              read and outputs written once, over 3.35 TB/s); one more
              step under torch.profiler gives the idle share and the
              dropout kernel's device time.
8. train_stem — the same train step with set_stem_impl("kernel"): the two
              RGB stems' convs (DetailBranch S1_1, StemBlock conv) run
              stem_conv3x3_s2 (kernel 1 forward, the library conv's
              gradients backward). From one set of weights and one batch, a
              step on the plain route and 2 on the kernel route: exactly 2
              stem_conv3x3_s2 launches a step, the first step's loss within
              1e-2 (relative) of the plain route's; the Function's f32
              output at the steps' inputs against its plain version (rel <=
              1e-4) and, with dx and dk, against the library conv on the
              card (rel < 1e-2); timed warm on the layer's packed table,
              cold and by the profiler's device time, beside its plain
              version, f32 F.conv2d (TF32 off: the same function) and bf16
              F.conv2d.
9. parity   — one f32 train step at (4, 64, 128) with dropout on, TF32 off,
              on the card (dropout kernel) and on the CPU (its plain
              version), same weights and generator seed: loss rel < 1e-4,
              per-group gradient cosine > 0.9999, parameters after the step
              rel < 1e-4; and PyTorch's avg_pool2d backward on a
              channels_last input, card against CPU, raw and through the
              port's pool (which must agree to 1e-5).

Then a {"kernels": [...]} line, the nvidia-smi name/power-limit line, and as
the last line {"ok": true, "device": {...}}.
"""

import contextlib
import copy
import json
import os
import re
import subprocess
import sys
import time
import urllib.request

import numpy as np
import torch
import torch.nn.functional as F

H, W = 1024, 2048
ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "bisenetv2_city.json")
V1_CONFIG = os.path.join(ROOT, "configs", "bisenetv1_city.json")
KERNEL_GATE = 1e-2     # rel max-diff, kernel vs its plain version
ARGMAX_GATE = 0.995    # bench.py:296-297
LOGITS_GATE = 2e-2
# A random model's argmax agreement between two bf16 paths depends on how
# many of its pixels sit within rounding noise of a tie between classes.
# Measured on an H100 (700 W) at 1024×2048 over init seeds 0-7 (BN seed =
# init seed + 1): seeds 0, 3 and 7 agreed on 0.979-0.991 of the pixels, the
# other five on more than 0.9996; seed 0's logits still agreed to rel
# 0.012. The smoke model uses seed 1.
WEIGHT_SEED = 1
# The same holds for BiSeNetV1, where the two 7×7 stems of the kernel route
# round once after conv, BN and ReLU and the plain path three times.
# tools/v1_seed_scan_torch.py on an H100 (700 W), 1024×2048, the v1_slice
# phase's first frame, init seeds 0-5 (BN seed = init seed + 1): seed 0
# agreed on 0.9937 of the pixels at logits rel 0.0201, seed 3 on 0.9855, and
# seed 4's logits lay at rel 0.0227, each past a gate; seeds 1, 2 and 5
# passed (0.9990-0.9997, rel 0.0148-0.0170).
V1_WEIGHT_SEED = 2
SOURCES = {
    "stem_conv_bn_relu_s2": ("mds_tpu_torch/csrc/stem.cu",
                             "mds_tpu/ops/pallas/stem.py:143"),
    "stem_conv_bn_relu_s2_window": ("mds_tpu_torch/csrc/stem.cu",
                                    "mds_tpu/ops/pallas/stem.py:265"),
    "stem_s1_pair_fused": ("mds_tpu_torch/csrc/stem.cu",
                           "mds_tpu/ops/pallas/stem.py:408"),
    "detail_s1s2_fused": ("mds_tpu_torch/csrc/stem.cu",
                          "mds_tpu/ops/pallas/stem.py:582"),
    "stemblock_fused": ("mds_tpu_torch/csrc/stem.cu",
                        "mds_tpu/ops/pallas/stem.py:775"),
    "dropout_u8": ("mds_tpu_torch/csrc/dropout.cu",
                   "mds_tpu/ops/pallas/dropout.py:54"),
    "stem7_conv_bn_relu_s2": ("mds_tpu_torch/csrc/stem7.cu",
                              "mds_tpu/ops/pallas/stem.py:911"),
    "depthwise3x3": ("mds_tpu_torch/csrc/depthwise.cu",
                     "mds_tpu/ops/pallas/depthwise.py:112"),
    "depthwise3x3_dma": ("mds_tpu_torch/csrc/depthwise.cu",
                         "mds_tpu/ops/pallas/depthwise_dma.py:44"),
    "upsample_argmax": ("mds_tpu_torch/csrc/upsample_argmax.cu",
                        "mds_tpu/ops/pallas/upsample_argmax.py:76"),
    "detail_tail_fused": ("mds_tpu_torch/csrc/detail_tail.cu",
                          "mds_tpu/ops/pallas/stem.py:1148"),
    "conv3x3_bn_relu": ("mds_tpu_torch/csrc/conv3x3.cu",
                        "mds_tpu/ops/pallas/conv3x3.py:69"),
    # kernel 1's training form (a custom_vjp over _stem_fwd)
    "stem_conv3x3_s2": ("mds_tpu_torch/csrc/stem.cu",
                        "mds_tpu/ops/pallas/stem.py:1235"),
}
# the kernels that run warpgroup MMA (csrc/wgmma.cuh): their SASS must show
# HGMMA and no HMMA (stem_kernel: kernels 1 and 2; pair_kernel: 3;
# detail_head_kernel: 4; stemblock_kernel: 5; stem7_kernel: 6)
WGMMA_KERNELS = ("conv3x3_kernel", "detail_tail_kernel", "stem_kernel", "pair_kernel",
                 "detail_head_kernel", "stemblock_kernel", "stem7_kernel")
# one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores
# the share of a depthwise kernel's outputs that must equal its plain
# version's bit for bit (both sum the same f32 products in the same order);
# also of stem kernels 1 and 2 (the f32 sum of the exact products of x and
# the f32 table, in another order than the plain version's)
BIT_EQUAL_GATE = 0.999
# kernel 1's f32 training form against its plain version: the round's f32
# gate (both the f32 sum of the same exact products, in another order)
F32_GATE = 1e-4
UPSAMPLE_ARGMAX_GATE = 0.9999  # label agreement with the plain version
# the main head's dropout input at the config's batch and crop (16, 512×1024)
DROPOUT_SHAPE = (16, 1024, 64, 128)


def emit(**kw):
    print(json.dumps(kw), flush=True)


def rel(a, b):
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def cuda_ms(fn, n=20):
    """Median over n single runs, CUDA events, after 3 warmup runs."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, kernel, n=10, per_call=False):
    """The mean device time of `kernel` (a substring of its name; "": every
    kernel) per launch, or per call of fn with per_call, over n calls of fn
    under torch.profiler, or "not measured"."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not e.is_user_annotation and kernel in e.name]
    total = sum(e.device_time_total for e in ev) / 1e3
    return total / (n if per_call else len(ev)) if ev and total > 0 else "not measured"


def sass_check(lib):
    """HGMMA and HMMA instruction counts in the SASS of each kernel named in
    WGMMA_KERNELS (cuobjdump of the built library); raises unless every
    instantiation has HGMMA and none has HMMA."""
    import shutil

    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        fn = body.split("\n", 1)[0].strip()
        for k in WGMMA_KERNELS:
            if k in fn:
                counts[fn] = {"kernel": k, "HGMMA": body.count("HGMMA"),
                              "HMMA": len(re.findall(r"\bHMMA\b", body))}
    emit(phase="sass", functions=counts)
    for k in WGMMA_KERNELS:
        fns = [c for c in counts.values() if c["kernel"] == k]
        if not fns or any(c["HGMMA"] == 0 or c["HMMA"] for c in fns):
            raise RuntimeError(f"{k}: its SASS lacks HGMMA or has HMMA: {fns}")
    return counts


def bound(n_bytes, flops, flop_rate=BF16_FLOP_PER_S):
    """(least ms, what bounds it): bytes over HBM's rate, operations over
    `flop_rate` (the bf16 tensor rate unless the work is f32 on the CUDA
    cores), whichever is larger."""
    t_mem, t_ops = n_bytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def conv_flops(out, k):
    """2·MACs of a conv whose output is `out` (B, O, H, W) with kernel k."""
    return 2 * out.numel() * k[0].numel()


def folded_bn(rng, n, dev):
    """Folded eval-BN (scale, bias): gamma ~N(1, .1), beta ~N(0, .1),
    mean ~N(0, .1), var ~U(.5, 1.5)."""
    g, b = rng.normal(1, 0.1, n), rng.normal(0, 0.1, n)
    m, v = rng.normal(0, 0.1, n), rng.uniform(0.5, 1.5, n)
    s = g / np.sqrt(v + 1e-5)
    return (torch.tensor(s, dtype=torch.float32, device=dev),
            torch.tensor(b - m * s, dtype=torch.float32, device=dev))


def conv_w(rng, o, i, ks, dev):
    std = np.sqrt(2.0 / (o * ks * ks))
    return torch.tensor(rng.normal(0, std, (o, i, ks, ks)), dtype=torch.float32,
                        device=dev)


def phase_kernels(dev):
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.normal(0, 1, (1, H, W, 3)), dtype=torch.float32,
                     device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    results = stem_rows(dev, x, rng)
    calls = {
        "stem_s1_pair_fused": [(
            x, conv_w(rng, 64, 3, 3, dev), *folded_bn(rng, 64, dev),
            conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev), True)],
        "detail_s1s2_fused": [(
            x, conv_w(rng, 64, 3, 3, dev), *folded_bn(rng, 64, dev),
            conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev),
            conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev))],
        "stemblock_fused": [(
            x, conv_w(rng, 16, 3, 3, dev), *folded_bn(rng, 16, dev),
            conv_w(rng, 8, 16, 1, dev), *folded_bn(rng, 8, dev),
            conv_w(rng, 16, 8, 3, dev), *folded_bn(rng, 16, dev),
            conv_w(rng, 16, 32, 3, dev), *folded_bn(rng, 16, dev))],
        # BiSeNetV1's two 7×7 RGB stems (ResNet18 conv1, SpatialPath conv1)
        "stem7_conv_bn_relu_s2": [
            (x, conv_w(rng, 64, 3, 7, dev), *folded_bn(rng, 64, dev), True)],
    }
    # the kernels whose model routes pack their weights once: the packing
    # function of the arguments after x, and the kernel's name in a trace
    warm = {"stem_s1_pair_fused": (lambda *a: stem.pack_s1_pair(*a[:6]), "pair_kernel"),
            "detail_s1s2_fused": (stem.pack_detail_head, "detail_head_kernel"),
            "stemblock_fused": (stem.pack_stemblock, "stemblock_kernel"),
            "stem7_conv_bn_relu_s2": (lambda k, s, b, relu: stem.pack_stem7(k, s, b),
                                      "stem7_kernel")}
    # the kernels held at the frame to a bit-equal share >= BIT_EQUAL_GATE
    # with their plain version, as stem_rows holds kernels 1 and 2
    share_gated = ("stemblock_fused", "stem7_conv_bn_relu_s2")
    for name, arg_sets in calls.items():
        kernel = getattr(stem, name)
        plain = getattr(stem, name + "_plain")
        res = {"max_abs_err": 0.0, "rel": 0.0, "bit_equal": 1.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": None, "shapes": []}
        for args in arg_sets:
            before = kernel.launches
            got = kernel(*args)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{name}: launch counter did not move")
            want = plain(*args)
            if not (got.shape == want.shape and got.dtype == torch.bfloat16
                    and got.is_contiguous(memory_format=torch.channels_last)):
                raise RuntimeError(f"{name}: bad output {got.shape} {got.dtype}")
            r = rel(got, want)
            if not (torch.isfinite(got.float()).all() and r < KERNEL_GATE):
                raise RuntimeError(f"{name}: rel max-diff {r} >= {KERNEL_GATE}")
            res["max_abs_err"] = max(res["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            res["rel"] = max(res["rel"], r)
            eq = share_equal(bits(got), bits(want))
            if name in share_gated and eq < BIT_EQUAL_GATE:
                raise RuntimeError(f"{name}: bit-equal share {eq} < {BIT_EQUAL_GATE}")
            res["bit_equal"] = min(res["bit_equal"], eq)
            # kernel and plain timed in turns on the same inputs
            ms = cuda_ms(lambda: kernel(*args))
            plain_ms = cuda_ms(lambda: plain(*args))
            extra = {}
            if name in warm:
                # warm on its weights packed once, as the route calls it (`ms`);
                # cold, packing in the call; the kernel's own device time
                pack, dev_kernel = warm[name]
                packed = pack(*args[1:])
                # the warm call, the routes' own, gives the cold call's output
                if not torch.equal(kernel(*args, packed=packed), got):
                    raise RuntimeError(f"{name}: output on packed weights differs "
                                       "from the one packing in the call")
                extra = {"cold_ms": ms,
                         "device_ms": device_ms(lambda: kernel(*args, packed=packed),
                                                dev_kernel)}
                ms = cuda_ms(lambda: kernel(*args, packed=packed))
                for k, v in extra.items():
                    res[k] = v
            res["ms"] += ms
            res["plain_ms"] += plain_ms
            x_in, ks = args[0], [a for a in args[1:] if torch.is_tensor(a) and a.dim() == 4]
            flops = {  # the convs each kernel computes, from this run's shapes
                "stem_s1_pair_fused": lambda: 2 * x_in.numel() // 3 // 4 * 64 * (27 + 576),
                "stem7_conv_bn_relu_s2": lambda: conv_flops(got, ks[0]),
                "detail_s1s2_fused": lambda: 2 * x_in.numel() // 3 // 4 * 64 * (27 + 576)
                + conv_flops(got, ks[2]),
                "stemblock_fused": lambda: 2 * x_in.numel() // 3 // 4 * (16 * 27 + 8 * 16)
                + 2 * got.numel() * (8 * 9 + 32 * 9),
            }[name]()
            b_ms, b_by = bound(nbytes(*[a for a in args if torch.is_tensor(a)], got),
                               flops)
            res["bound_ms"] += b_ms
            res["bound_by"] = b_by
            shape = {"out": list(got.shape), "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": b_ms, **extra}
            if name == "stem7_conv_bn_relu_s2":
                # the library's one call for the same conv: bf16 F.conv2d with
                # the folded weight and bias (the ReLU left out)
                k, scale, bias = args[1], args[2], args[3]
                wf = (k.float() * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
                bf = bias.to(torch.bfloat16)
                pad = k.shape[-1] // 2
                shape["library_ms"] = cuda_ms(
                    lambda: F.conv2d(x, wf, bf, stride=2, padding=pad))
                res["library_ms"] = (res["library_ms"] or 0.0) + shape["library_ms"]
            res["shapes"].append(shape)
        emit(phase="kernels", kernel=name, plain="library ops in f32, TF32 off",
             **res)
        results[name] = res
    emit(phase="kernels", kernel="stem7_conv_bn_relu_s2", ragged=stem7_ragged(dev))
    emit(phase="kernels", kernel="stemblock_fused", ragged=stemblock_ragged(dev))
    emit(phase="kernels", kernel="stem_conv_bn_relu_s2", ragged=stem_ragged(dev))
    return results


def stem_rows(dev, x, rng):
    """Kernels 1 and 2 at the stem route's two RGB stems (DetailBranch S1_1
    → 64, StemBlock conv → 16, folded BN, ReLU) on the frame-sized x: each
    against the plain version (rel, bit-equal share), kernel 2 bit for bit
    against kernel 1; timed warm on the packed table (as the route calls
    them: `ms`) and cold, packing in the call, by the profiler's device time,
    beside the plain version and one bf16 F.conv2d with the folded weight
    and bias (no ReLU)."""
    from mds_tpu_torch.ops import stem

    stems = [(x, conv_w(rng, o, 3, 3, dev), *folded_bn(rng, o, dev), True)
             for o in (64, 16)]
    packs = [stem.pack_stem(*args[1:4]) for args in stems]
    results = {}
    for name in ("stem_conv_bn_relu_s2", "stem_conv_bn_relu_s2_window"):
        kernel = getattr(stem, name)
        res = {"max_abs_err": 0.0, "rel": 0.0, "bit_equal": 1.0, "ms": 0.0, "cold_ms": 0.0,
               "device_ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "shapes": []}
        for args, packed in zip(stems, packs):
            got, want, r = check_kernel_output(
                name, lambda *a: kernel(*a, packed=packed), stem.stem_conv_bn_relu_s2_plain,
                args, counter=kernel)
            eq = share_equal(bits(got), bits(want))
            if eq < BIT_EQUAL_GATE:
                raise RuntimeError(f"{name}: bit-equal share {eq} < {BIT_EQUAL_GATE}")
            if name == "stem_conv_bn_relu_s2_window" and not torch.equal(
                    bits(got), bits(stem.stem_conv_bn_relu_s2(*args, packed=packed))):
                raise RuntimeError(f"{name}: differs from stem_conv_bn_relu_s2")
            k, scale, bias = args[1:4]
            wf = (k * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
            bf = bias.to(torch.bfloat16)
            b_ms, res["bound_by"] = bound(nbytes(x, k, scale, bias, got), conv_flops(got, k))
            shape = {"out": list(got.shape), "rel": r, "bit_equal": eq,
                     "ms": cuda_ms(lambda: kernel(*args, packed=packed)),
                     "cold_ms": cuda_ms(lambda: kernel(*args)),
                     "device_ms": device_ms(lambda: kernel(*args, packed=packed),
                                            "stem_kernel"),
                     "plain_ms": cuda_ms(lambda: stem.stem_conv_bn_relu_s2_plain(*args)),
                     "library_ms": cuda_ms(lambda: F.conv2d(x, wf, bf, stride=2, padding=1)),
                     "bound_ms": b_ms}
            res["shapes"].append(shape)
            res["max_abs_err"] = max(res["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            res["rel"], res["bit_equal"] = max(res["rel"], r), min(res["bit_equal"], eq)
            for key in ("ms", "cold_ms", "device_ms", "plain_ms", "library_ms", "bound_ms"):
                if isinstance(shape[key], float) and isinstance(res[key], float):
                    res[key] += shape[key]
                else:
                    res[key] = "not measured"
        if name == "stem_conv_bn_relu_s2_window":
            res["equal_to_stem_conv_bn_relu_s2"] = True  # checked above
        emit(phase="kernels", kernel=name, plain="library ops in f32, TF32 off",
             library="bf16 F.conv2d, folded weight and bias, no ReLU", **res)
        results[name] = res
    return results


def stem_ragged(dev):
    """Kernels 1 and 2 on ragged tiles (W/2 not a multiple of 64), B > 1, O
    from 8 to 128, with and without ReLU (rel, bit-equal share, kernel 2
    bit-equal to kernel 1), and kernel 1's f32 training form on the same
    inputs (rel <= F32_GATE). Not counted as main-path launches."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(7)
    out = []
    for b, h, w, o, relu in ((2, 18, 134, 64, True), (1, 6, 2050, 16, False),
                             (3, 2, 2, 8, True), (1, 34, 70, 128, True),
                             (2, 10, 14, 24, False), (1, 36, 44, 64, True),
                             (2, 18, 262, 16, False), (1, 100, 66, 24, False)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        args = (x, conv_w(rng, o, 3, 3, dev), *folded_bn(rng, o, dev), relu)
        want = stem.stem_conv_bn_relu_s2_plain(*args)
        k1 = stem.stem_conv_bn_relu_s2(*args)
        k2 = stem.stem_conv_bn_relu_s2_window(*args)
        kb = args[1].to(torch.bfloat16)
        f32 = stem.stem_conv3x3_s2(x, kb)
        rec = {"shape": [b, h, w, o], "relu": relu, "rel": rel(k1, want),
               "bit_equal": share_equal(bits(k1), bits(want)),
               "window_equal": torch.equal(bits(k1), bits(k2)),
               "f32_rel": rel(f32, stem.stem_conv3x3_s2_plain(x, kb)),
               "f32_dtype": str(f32.dtype)}
        out.append(rec)
        if (k1.shape != want.shape or not torch.isfinite(k1.float()).all()
                or rec["rel"] >= KERNEL_GATE or rec["bit_equal"] < BIT_EQUAL_GATE
                or not rec["window_equal"] or f32.dtype != torch.float32
                or rec["f32_rel"] > F32_GATE):
            raise RuntimeError(f"stem_conv_bn_relu_s2 ragged: {rec}")
    return out


def stem7_ragged(dev):
    """The 7×7 stem on shapes whose tiles are ragged (8×32 output tiles cut
    by the image's edge), on B > 1, and on every O % 8 == 0 up to 128,
    against its plain version: rel max-diff and the share of bit-equal
    outputs per shape. Not counted as main-path launches."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(5)
    out = []
    for b, h, w, o, relu in ((1, 36, 44, 64, True), (2, 18, 70, 32, False),
                             (1, 64, 130, 128, True), (3, 2, 2, 8, True),
                             (1, 100, 66, 24, False)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        args = (x, conv_w(rng, o, 3, 7, dev), *folded_bn(rng, o, dev), relu)
        got, want = stem.stem7_conv_bn_relu_s2(*args), stem.stem7_conv_bn_relu_s2_plain(*args)
        r = rel(got, want)
        out.append({"shape": [b, h, w, o], "relu": relu, "rel": r,
                    "bit_equal": share_equal(bits(got), bits(want))})
        if got.shape != want.shape or not torch.isfinite(got.float()).all() or r >= KERNEL_GATE:
            raise RuntimeError(f"stem7_conv_bn_relu_s2 at {out[-1]}")
    return out


def stemblock_ragged(dev):
    """The StemBlock at B = 2 with H/4 and W/4 off its 61-column strips, at
    three strips, and at H = W = 4, against its plain version: rel max-diff
    and the share of bit-equal outputs per shape. Not counted as main-path
    launches."""
    from mds_tpu_torch.ops import stem

    rng = np.random.default_rng(8)
    out = []
    for b, h, w in ((2, 36, 260), (2, 20, 252), (1, 4, 4), (1, 68, 500)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                         device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
        args = (x, conv_w(rng, 16, 3, 3, dev), *folded_bn(rng, 16, dev),
                conv_w(rng, 8, 16, 1, dev), *folded_bn(rng, 8, dev),
                conv_w(rng, 16, 8, 3, dev), *folded_bn(rng, 16, dev),
                conv_w(rng, 16, 32, 3, dev), *folded_bn(rng, 16, dev))
        got, want = stem.stemblock_fused(*args), stem.stemblock_fused_plain(*args)
        r = rel(got, want)
        out.append({"shape": [b, h, w], "rel": r,
                    "bit_equal": share_equal(bits(got), bits(want))})
        if got.shape != want.shape or not torch.isfinite(got.float()).all() or r >= KERNEL_GATE:
            raise RuntimeError(f"stemblock_fused at {out[-1]}")
    return out


def bits(t):
    """A bf16 or f32 tensor's bit patterns in NHWC order (-0 != +0)."""
    it = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.permute(0, 2, 3, 1).contiguous().view(it)


def share_equal(a, b):
    """The exact share of equal elements (a count over the size)."""
    return (a == b).sum().item() / a.numel()


def _clone(a):
    return a.clone() if torch.is_tensor(a) else a


class _Spy:
    """Stands in for a kernel wrapper in its module: records each call's
    arguments (each through `keep`: cloned by default) and calls the
    wrapper. The wrapper counts its launch through its module's name, so
    `launches` reads and writes the wrapper's."""

    def __init__(self, real, keep=_clone):
        self.real, self.keep, self.seen = real, keep, []

    @property
    def launches(self):
        return self.real.launches

    @launches.setter
    def launches(self, n):
        self.real.launches = n

    def __call__(self, *args):
        self.seen.append(tuple(self.keep(a) for a in args))
        return self.real(*args)


@contextlib.contextmanager
def captured(module, name, keep=_clone):
    """The arguments of every call of module.<name> in the block, each
    through `keep` (cloned by default; the call itself goes through)."""
    spy = _Spy(getattr(module, name), keep)
    setattr(module, name, spy)
    try:
        yield spy.seen
    finally:
        setattr(module, name, spy.real)


def main_path_inputs(e2e, frame):
    """The depthwise kernel's 16 (x, w, stride), the fused tail's (logits,
    scale) and the detail tail's arguments of one served BiSeNetV2 frame, and
    the conv3 kernel's of one frame on the window-stem + conv3 route: real
    activations at the shapes the main path gives the kernels."""
    from mds_tpu_torch.ops import conv3x3, depthwise, stem, upsample_argmax

    with torch.no_grad(), route(**ALL_ROUTES):
        with captured(depthwise, "depthwise3x3") as dw, \
                captured(upsample_argmax, "upsample_argmax") as ua, \
                captured(stem, "detail_tail_fused") as tail:
            e2e.model.pred(normalized(e2e, frame))
    with torch.no_grad(), route(**STEM_DMA_CONV3_ROUTES):
        with captured(conv3x3, "conv3x3_bn_relu") as c3:
            e2e.model.pred(normalized(e2e, frame))
    torch.cuda.synchronize()
    return dw, ua, tail, c3


def check_kernel_output(name, kernel, plain, args, dtype=torch.bfloat16, counter=None):
    """One launch of `kernel` (the counter of `counter`, else of `kernel`,
    must move by one) against its plain version on the same arguments:
    (output, plain output, rel)."""
    counter = counter or kernel
    before = counter.launches
    got = kernel(*args)
    torch.cuda.synchronize()
    if counter.launches != before + 1:
        raise RuntimeError(f"{name}: launch counter did not move")
    want = plain(*args)
    if not (got.shape == want.shape and got.dtype == dtype
            and got.is_contiguous(memory_format=torch.channels_last)):
        raise RuntimeError(f"{name}: bad output {got.shape} {got.dtype}")
    r = rel(got, want)
    if not torch.isfinite(got.float()).all() or r >= KERNEL_GATE:
        raise RuntimeError(f"{name}: rel max-diff {r} >= {KERNEL_GATE}")
    return got, want, r


def detail_tail_row(call, detail, x):
    """detail_tail_fused at the served frame's /4 detail feature against its
    plain version, timed cold (weights folded and packed in the call) and
    warm (on the packed weights, as the served route calls it: `ms`), its
    device time read by the profiler, beside its plain version and the chain
    the plain route runs (the DetailBranch's five ConvBNReLU modules: cuDNN
    conv, unfolded BN, ReLU); no single PyTorch call computes the function
    (library_ms null). Also the chain that kernel 4 replaces (S1_1, S1_2,
    S2_1) on the frame x, the yardstick of kernel 4's row, which has no
    single call either."""
    from mds_tpu_torch.ops import stem

    name = "detail_tail_fused"
    call = call[:16]  # the captured call's last argument: the model's pack
    got, want, r = check_kernel_output(name, stem.detail_tail_fused,
                                       stem.detail_tail_fused_plain, call)
    y = call[0]
    packed = stem.pack_detail_tail(*call[1:])

    def chain():
        xs = [y]
        with torch.inference_mode():
            for layer in detail._tail():
                xs = layer(xs)
        return xs[0]

    def head_chain():
        with torch.inference_mode():
            return detail.S2_1(detail.S1_2(detail.S1_1([x])))[0]

    cold_ms = cuda_ms(lambda: stem.detail_tail_fused(*call))
    ms = cuda_ms(lambda: stem.detail_tail_fused(*call, packed))
    dev_ms = device_ms(lambda: stem.detail_tail_fused(*call, packed),
                       "detail_tail_kernel")
    plain_ms = cuda_ms(lambda: stem.detail_tail_fused_plain(*call))
    chain_ms = cuda_ms(chain)
    emit(phase="kernels", kernel="detail_s1s2_fused", shape=list(x.shape),
         chain_ms=cuda_ms(head_chain), chain="the plain route's S1_1, S1_2, "
         "S2_1 ConvBNReLU modules (bf16 cuDNN conv, f32 BN, ReLU)")
    b, _, h4, w4 = y.shape
    p4, p8 = b * h4 * w4, b * (h4 // 2) * (w4 // 2)
    flops = 2 * (2 * p4 * 64 * 576 + p8 * 128 * 576 + 2 * p8 * 128 * 1152)
    b_ms, b_by = bound(nbytes(*[a for a in call if torch.is_tensor(a)], got), flops)
    res = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    emit(phase="kernels", kernel=name, shape=list(y.shape), rel=r,
         bit_equal=share_equal(bits(got), bits(want)), cold_ms=cold_ms,
         device_ms=dev_ms, chain_ms=chain_ms,
         chain="the plain route's five ConvBNReLU modules (bf16 cuDNN conv, "
         "f32 BN, ReLU)", plain="library ops in f32, TF32 off", **res)
    return res


def conv3x3_row(call):
    """conv3x3_bn_relu at DetailBranch S1_2's input of a frame on the
    window-stem + conv3 route against its plain version, timed cold (k packed
    in the call) and warm (on the packed k, as the route calls it: `ms`),
    its device time read by the profiler, beside its plain version and one
    bf16 F.conv2d with the folded weight and bias (no ReLU)."""
    from mds_tpu_torch.ops import conv3x3 as c3

    name = "conv3x3_bn_relu"
    call = call[:5]  # the captured call's last argument: the model's pack
    got, want, r = check_kernel_output(name, c3.conv3x3_bn_relu,
                                       c3.conv3x3_bn_relu_plain, call)
    x, k, scale, bias = call[:4]
    wp = c3.pack_conv3x3(k)
    wf = (k.float() * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
    bf = bias.to(torch.bfloat16)
    cold_ms = cuda_ms(lambda: c3.conv3x3_bn_relu(*call))
    ms = cuda_ms(lambda: c3.conv3x3_bn_relu(*call, wp))
    dev_ms = device_ms(lambda: c3.conv3x3_bn_relu(*call, wp), "conv3x3_kernel")
    plain_ms = cuda_ms(lambda: c3.conv3x3_bn_relu_plain(*call))
    library_ms = cuda_ms(lambda: F.conv2d(x, wf, bf, padding=1))
    b_ms, b_by = bound(nbytes(x, k, scale, bias, got), conv_flops(got, k))
    res = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    emit(phase="kernels", kernel=name, shape=list(x.shape), out=list(got.shape),
         rel=r, bit_equal=share_equal(bits(got), bits(want)), cold_ms=cold_ms,
         device_ms=dev_ms,
         plain="f32 conv on bf16(k), then ·scale + bias, ReLU; TF32 off",
         library="bf16 F.conv2d, folded weight and bias, no ReLU", **res)
    return res


def conv_kernels_ragged(dev):
    """The S1 pair, the detail tail and the conv3 kernel on ragged tiles, B > 1 and, for conv3, C_in from 3
    to 64 and C_out from 8 to 136, against their plain versions. Not counted
    as main-path launches."""
    from mds_tpu_torch.ops import conv3x3 as c3, stem

    rng = np.random.default_rng(7)

    def image(b, h, w, c=3):  # RGB as normalized, features after a ReLU
        x = torch.tensor(rng.normal(0, 1, (b, h, w, c)), dtype=torch.float32,
                         device=dev)
        return (x if c == 3 else x.relu()).to(torch.bfloat16).permute(0, 3, 1, 2)

    out = {"stem_s1_pair_fused": [], "detail_tail_fused": [], "conv3x3_bn_relu": []}

    def record(name, rec, got, want):
        rec.update(rel=rel(got, want), bit_equal=share_equal(bits(got), bits(want)))
        out[name].append(rec)
        if (got.shape != want.shape or not torch.isfinite(got.float()).all()
                or rec["rel"] >= KERNEL_GATE):
            raise RuntimeError(f"{name} ragged: {rec}")

    for b, h, w, relu2 in ((1, 36, 70, True), (2, 18, 10, False), (1, 2, 2, True),
                           (2, 14, 262, True)):
        args = (image(b, h, w), conv_w(rng, 64, 3, 3, dev), *folded_bn(rng, 64, dev),
                conv_w(rng, 64, 64, 3, dev), *folded_bn(rng, 64, dev), relu2)
        record("stem_s1_pair_fused", {"shape": [b, h, w], "relu2": relu2},
               stem.stem_s1_pair_fused(*args), stem.stem_s1_pair_fused_plain(*args))
    for b, h4, w4 in ((2, 22, 38), (1, 2, 2), (1, 34, 130)):
        params = []
        for o, i in stem._TAIL_SHAPES:
            params += [conv_w(rng, o, i, 3, dev), *folded_bn(rng, o, dev)]
        args = (image(b, h4, w4, 64), *params)
        record("detail_tail_fused", {"shape": [b, 64, h4, w4]},
               stem.detail_tail_fused(*args), stem.detail_tail_fused_plain(*args))
    for b, h, w, ci, co, relu in ((2, 17, 33, 64, 64, True), (1, 9, 40, 3, 8, True),
                                  (2, 31, 15, 16, 16, False), (1, 13, 27, 24, 136, True),
                                  (1, 8, 8, 40, 72, False), (1, 5, 70, 48, 32, True)):
        args = (image(b, h, w, ci), conv_w(rng, co, ci, 3, dev), *folded_bn(rng, co, dev),
                relu)
        record("conv3x3_bn_relu", {"shape": [b, h, w, ci], "c_out": co, "relu": relu},
               c3.conv3x3_bn_relu(*args), c3.conv3x3_bn_relu_plain(*args))
    return out


def depthwise_rows(dw_calls):
    """depthwise3x3 at the frame's 16 shapes and depthwise3x3_dma at its
    stride-1 ones against their plain version (rel max-diff, bit-equal
    share; the DMA kernel bit-equal to kernel 9), each timed beside its
    plain version, one bf16 F.conv2d with groups = C (the library call) and
    the port's library route (repeat_interleave + depthwise conv); beside
    the DMA kernel's device time, kernel 9's at the same shape."""
    from mds_tpu_torch.models.layers import _repeat_channels
    from mds_tpu_torch.ops import depthwise

    def library(x, w, s):
        return F.conv2d(x, w, None, s, 1, 1, x.shape[1])

    def port_route(x, w, s):
        c, co = x.shape[1], w.shape[0]
        x = _repeat_channels(x, co // c) if co != c else x
        return F.conv2d(x, w, None, s, 1, 1, co)

    rows = {}
    for name in ("depthwise3x3", "depthwise3x3_dma"):
        kernel = getattr(depthwise, name)
        res = {"max_abs_err": 0.0, "rel": 0.0, "bit_equal": 1.0, "ms": 0.0,
               "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
               "port_route_ms": 0.0, "device_ms": 0.0, "library_device_ms": 0.0,
               "shapes": []}
        for x, w, s in dw_calls:
            if name == "depthwise3x3_dma" and s != 1:
                continue
            args = (x, w, s) if name == "depthwise3x3" else (x, w)
            before = kernel.launches
            got = kernel(*args)
            torch.cuda.synchronize()
            if kernel.launches != before + 1:
                raise RuntimeError(f"{name}: launch counter did not move")
            want = depthwise.depthwise3x3_plain(x, w, s)
            if not (got.shape == want.shape and got.dtype == x.dtype
                    and got.is_contiguous(memory_format=torch.channels_last)):
                raise RuntimeError(f"{name}: bad output {got.shape} {got.dtype}")
            r, eq = rel(got, want), share_equal(bits(got), bits(want))
            shape = {"x": list(x.shape), "stride": s, "m": w.shape[0] // x.shape[1],
                     "rel": r, "bit_equal": eq}
            if name == "depthwise3x3_dma":
                k9 = depthwise.depthwise3x3(x, w, 1)
                shape["equal_to_depthwise3x3"] = torch.equal(bits(got), bits(k9))
                if not shape["equal_to_depthwise3x3"]:
                    raise RuntimeError(f"{name}: differs from depthwise3x3 at {shape}")
            if not torch.isfinite(got.float()).all() or r >= KERNEL_GATE or eq < BIT_EQUAL_GATE:
                raise RuntimeError(f"{name}: {shape}")
            # kernel, plain version, library call and library route in turns
            shape["ms"] = cuda_ms(lambda: kernel(*args))
            shape["plain_ms"] = cuda_ms(lambda: depthwise.depthwise3x3_plain(x, w, s))
            shape["library_ms"] = cuda_ms(lambda: library(x, w, s))
            shape["port_route_ms"] = cuda_ms(lambda: port_route(x, w, s))
            # device time per call, the kernel's and the library call's; at
            # kernel 10's shapes also kernel 9's
            shape["device_ms"] = device_ms(lambda: kernel(*args), "dw3x3")
            if name == "depthwise3x3_dma":
                shape["k9_device_ms"] = device_ms(lambda: depthwise.depthwise3x3(x, w, 1),
                                                  "dw3x3_kernel")
                res["k9_device_ms"] = res.get("k9_device_ms", 0.0) + (
                    shape["k9_device_ms"] if isinstance(shape["k9_device_ms"], float)
                    else float("nan"))
            shape["library_device_ms"] = device_ms(lambda: library(x, w, s), "",
                                                   per_call=True)
            # each input read once, each output written once; 9 f32
            # multiply-adds per output on the CUDA cores
            shape["bound_ms"], res["bound_by"] = bound(nbytes(x, w, got),
                                                       2 * 9 * got.numel(),
                                                       F32_FLOP_PER_S)
            res["max_abs_err"] = max(res["max_abs_err"],
                                     (got.float() - want.float()).abs().max().item())
            res["rel"] = max(res["rel"], r)
            res["bit_equal"] = min(res["bit_equal"], eq)
            for k in ("ms", "plain_ms", "bound_ms", "library_ms", "port_route_ms",
                      "device_ms", "library_device_ms"):
                res[k] = (res[k] + shape[k] if isinstance(shape[k], float)
                          and isinstance(res[k], float) else "not measured")
            res["shapes"].append(shape)
        emit(phase="kernels", kernel=name, plain="f32 slices of the padded input, "
             "multiply, add in tap order", library="bf16 F.conv2d, groups = C_in",
             port_route="repeat_interleave + depthwise F.conv2d", **res)
        rows[name] = res
    return rows


def upsample_argmax_row(ua_call):
    """upsample_argmax at the frame's head logits against its plain version
    (label agreement, differing pixels), timed beside the plain version and
    the library chain the plain route runs (bf16 F.interpolate, argmax, int32
    cast), its device time read by the profiler; no single PyTorch call
    computes the function (library_ms null)."""
    from mds_tpu_torch.ops import upsample_argmax as ua

    logits, s = ua_call
    before = ua.upsample_argmax.launches
    got = ua.upsample_argmax(logits, s)
    torch.cuda.synchronize()
    if ua.upsample_argmax.launches != before + 1:
        raise RuntimeError("upsample_argmax: launch counter did not move")
    want = ua.upsample_argmax_plain(logits, s)
    b, c, h, w = logits.shape
    if got.shape != (b, h * s, w * s) or got.dtype != torch.int32:
        raise RuntimeError(f"upsample_argmax: bad output {got.shape} {got.dtype}")
    agree = share_equal(got, want)

    def chain():
        up = F.interpolate(logits, size=(h * s, w * s), mode="bilinear",
                           align_corners=False)
        return up.argmax(dim=1).to(torch.int32)

    ms = cuda_ms(lambda: ua.upsample_argmax(logits, s))
    dev_ms = device_ms(lambda: ua.upsample_argmax(logits, s), "upsample_argmax_kernel")
    plain_ms = cuda_ms(lambda: ua.upsample_argmax_plain(logits, s))
    chain_ms = cuda_ms(chain)
    # the separable passes: 3 f32 operations per vertical and per horizontal
    # value, one comparison per class after the first
    flops = 3 * b * c * h * s * (w + w * s) + b * h * s * w * s * (c - 1)
    b_ms, b_by = bound(nbytes(logits, got), flops, F32_FLOP_PER_S)
    # labels: the largest class-index difference, 0 where the maps agree
    res = {"max_abs_err": float((got - want).abs().max().item()), "ms": ms,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": None}
    emit(phase="kernels", kernel="upsample_argmax", shape=list(logits.shape),
         scale=s, dtype=str(logits.dtype), agreement=agree,
         differing_pixels=int((got != want).sum()), device_ms=dev_ms,
         chain_ms=chain_ms, chain="bf16 F.interpolate + argmax + int32 cast",
         plain="two f32 passes, bf16 rounding between, argmax", **res)
    if agree < UPSAMPLE_ARGMAX_GATE:
        raise RuntimeError(f"upsample_argmax: agreement {agree}")
    return res


def new_kernels_ragged(dev):
    """The depthwise kernels at odd H and W, B > 1, C = 3, 5, 12, m = 1, 2,
    6, both strides (and f32), against their plain version (depthwise3x3_dma
    also equal to depthwise3x3, bit for bit, and on its TMA form at
    tiles off the image, more tiles than one persistent pass, an image
    narrower than a tile, B = 3); upsample_argmax
    at odd h and w, B = 1 and 2, C = 1, 5, 19, 150, s = 1, 2, 3, 4, 5, 8, bf16
    and f32, against its plain version. Not counted as main-path
    launches."""
    from mds_tpu_torch.ops import depthwise, upsample_argmax as ua

    rng = np.random.default_rng(6)
    out = {"depthwise": [], "upsample_argmax": []}
    for b, h, w, c, m, s, dt in (
            (2, 17, 33, 3, 1, 1, torch.bfloat16), (2, 17, 33, 3, 2, 2, torch.bfloat16),
            (1, 31, 15, 5, 6, 1, torch.bfloat16), (3, 9, 9, 5, 1, 2, torch.bfloat16),
            (2, 21, 19, 12, 2, 1, torch.bfloat16), (1, 13, 27, 12, 6, 2, torch.bfloat16),
            (2, 7, 11, 12, 1, 1, torch.bfloat16), (1, 11, 13, 16, 6, 1, torch.float32),
            (2, 9, 10, 8, 1, 2, torch.float32), (2, 17, 37, 16, 6, 1, torch.bfloat16),
            (1, 19, 70, 8, 6, 2, torch.bfloat16), (3, 9, 33, 24, 2, 2, torch.bfloat16),
            (1, 6, 40, 8, 3, 1, torch.bfloat16), (2, 5, 9, 16, 4, 1, torch.bfloat16),
            # depthwise3x3_dma's TMA form: windows off the image on all four
            # sides, H and W off its tiles, more tiles than one persistent
            # pass (m = 1: 2 × 66 × 9 tiles of 2 × 32; m = 6: 67 × 7 of
            # 1 × 20), a 3 × 5 image (narrower than a tile, its windows off
            # all four sides), B = 3, f32; its masked form at C % 8 != 0
            (2, 131, 259, 64, 1, 1, torch.bfloat16), (1, 67, 129, 32, 6, 1, torch.bfloat16),
            (3, 13, 45, 32, 1, 1, torch.bfloat16), (1, 3, 5, 64, 6, 1, torch.bfloat16),
            (3, 35, 70, 16, 2, 1, torch.bfloat16), (2, 21, 45, 32, 6, 1, torch.float32),
            (1, 19, 37, 20, 3, 1, torch.float32), (2, 17, 33, 12, 6, 1, torch.bfloat16)):
        x = torch.tensor(rng.normal(0, 1, (b, h, w, c)), device=dev).relu().to(dt)
        x = x.permute(0, 3, 1, 2)
        wt = torch.tensor(rng.normal(0, 0.3, (c * m, 1, 3, 3)), device=dev).to(dt)
        want = depthwise.depthwise3x3_plain(x, wt, s)
        got = depthwise.depthwise3x3(x, wt, s)
        rec = {"shape": [b, h, w, c], "m": m, "stride": s, "dtype": str(dt),
               "rel": rel(got, want), "bit_equal": share_equal(bits(got), bits(want))}
        if s == 1:
            dma = bits(depthwise.depthwise3x3_dma(x, wt))
            rec["dma_equal"] = torch.equal(dma, bits(got))
            rec["dma_bit_equal"] = share_equal(dma, bits(want))
        out["depthwise"].append(rec)
        if (got.shape != want.shape or rec["rel"] >= KERNEL_GATE
                or rec["bit_equal"] < BIT_EQUAL_GATE or rec.get("dma_equal") is False
                or rec.get("dma_bit_equal", 1.0) < BIT_EQUAL_GATE):
            raise RuntimeError(f"depthwise ragged: {rec}")
    for b, h, w, c, s, dt in ((1, 9, 13, 1, 2, torch.bfloat16), (2, 7, 11, 5, 4, torch.bfloat16),
                              (1, 15, 9, 150, 8, torch.bfloat16), (1, 5, 7, 19, 3, torch.bfloat16),
                              (1, 11, 5, 5, 8, torch.float32), (2, 13, 37, 19, 8, torch.bfloat16),
                              (1, 9, 71, 19, 1, torch.bfloat16), (2, 7, 9, 19, 5, torch.bfloat16),
                              (2, 17, 35, 19, 8, torch.float32)):
        lg = torch.tensor(rng.normal(0, 1, (b, h, w, c)), device=dev).to(dt).permute(0, 3, 1, 2)
        got, want = ua.upsample_argmax(lg, s), ua.upsample_argmax_plain(lg, s)
        rec = {"shape": [b, c, h, w], "scale": s, "dtype": str(dt),
               "agreement": share_equal(got, want),
               "differing_pixels": int((got != want).sum())}
        out["upsample_argmax"].append(rec)
        if got.shape != want.shape or rec["agreement"] < UPSAMPLE_ARGMAX_GATE:
            raise RuntimeError(f"upsample_argmax ragged: {rec}")
    return out


def kernels():
    """Every kernel wrapper of the port, each with its launch counter."""
    from mds_tpu_torch.ops import conv3x3, depthwise, dropout, stem, upsample_argmax

    return (stem.KERNELS + dropout.KERNELS + depthwise.KERNELS
            + upsample_argmax.KERNELS + conv3x3.KERNELS)


def reset_counts():
    for k in kernels():
        k.launches = 0


def read_counts():
    return {k.__name__: k.launches for k in kernels()}


def phase_dropout(dev):
    """The dropout kernel at the main head's shape against its plain version,
    bit for bit, and its rule: keep rate, scale, seeds, backward mask."""
    from mds_tpu_torch.ops.dropout import (
        DropoutU8,
        dropout_u8,
        dropout_u8_plain,
        seed_words,
    )

    drop = 26  # round(0.1 · 256)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(DROPOUT_SHAPE, device=dev, generator=gen).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    k0, k1 = seed_words(torch.Generator().manual_seed(1))
    before = dropout_u8.launches
    got = dropout_u8(x, k0, k1, drop)
    torch.cuda.synchronize()
    if dropout_u8.launches != before + 1:
        raise RuntimeError("dropout_u8: launch counter did not move")
    want = dropout_u8_plain(x, k0, k1, drop)
    if not (got.is_contiguous(memory_format=torch.channels_last)
            and torch.equal(got.view(torch.int16), want.view(torch.int16))):
        raise RuntimeError("dropout_u8: not bit-identical to its plain version")
    # the mask itself: the kernel on ones (x holds exact zeros: randn draws
    # some, so y == 0 does not mean dropped)
    ones = torch.ones_like(x)
    keep = dropout_u8(ones, k0, k1, drop) != 0
    keep_frac = keep.float().mean().item()
    scale = torch.tensor(256 / 230, dtype=torch.bfloat16).item()
    nz = keep & (x != 0)
    ratio = (got.float()[nz] / x.float()[nz]).mean().item()
    same = torch.equal(keep, dropout_u8(ones, k0, k1, drop) != 0)
    other = torch.equal(keep, dropout_u8(ones, k0 ^ 1, k1, drop) != 0)
    xg = x.detach().requires_grad_(True)
    r = torch.randn(DROPOUT_SHAPE, device=dev, generator=gen).to(torch.bfloat16)
    (DropoutU8.apply(xg, k0, k1, drop) * r).sum().backward()  # r arrives NCHW
    grad_ok = torch.equal(xg.grad.view(torch.int16), torch.where(
        keep, (r.float() * scale).to(torch.bfloat16), 0.0).view(torch.int16))
    del ones, nz, xg, r
    ms = cuda_ms(lambda: dropout_u8(x, k0, k1, drop))
    plain_ms = cuda_ms(lambda: dropout_u8_plain(x, k0, k1, drop), n=5)
    # the library's one call for the same function: drop with probability
    # 26/256, scale the kept by 256/230 (in f32, not rounded to bf16 first);
    # its mask comes from its own generator and is also written out
    library_ms = cuda_ms(lambda: torch.native_dropout(x, drop / 256, True))
    b_ms, b_by = bound(nbytes(x, got), 0)
    res = {"max_abs_err": (got.float() - want.float()).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": library_ms}
    emit(phase="dropout", shape=list(DROPOUT_SHAPE), keep_fraction=keep_frac,
         mean_kept_ratio=ratio, bf16_scale=scale, same_seed_same_mask=same,
         other_seed_other_mask=not other, backward_mask_ok=grad_ok, **res)
    if abs(keep_frac - 230 / 256) > 0.002:
        raise RuntimeError(f"dropout_u8: keep fraction {keep_frac}")
    if abs(ratio - scale) > 1e-3 * scale or not same or other or not grad_ok:
        raise RuntimeError("dropout_u8: scale, seed or backward check failed")
    return res


def train_step_for(cfg, model, compute_dtype):
    """The config's optimizer, schedule and normalization around `model`."""
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.engine.lr_schedule import warmup_poly_lr
    from mds_tpu_torch.engine.optim import build_optimizer
    from mds_tpu_torch.engine.train_step import make_seg_train_step

    schedule = warmup_poly_lr(
        float(cfg.get("lr", "lr_start")), float(cfg.get("lr", "lr_power")),
        int(cfg.get("lr", "max_iter")),
        warmup_iter=int(cfg.get("lr", "warmup_iters")),
        warmup_ratio=float(cfg.get("lr", "warmup_ratio")),
        warmup=cfg.get("lr", "warmup", default="exp"))
    opt = build_optimizer(cfg, model, schedule)
    spec = get_spec(cfg.dataset_cfg(0)["spec"])
    step = make_seg_train_step(
        model, opt, [spec.mean], [spec.std],
        ohem_thresh=float(cfg.get("loss", "ohem_thresh")),
        compute_dtype=compute_dtype)
    return step, opt


def seg_batch(rng, b, h, w, n_classes):
    """uint8 images and labels as bench.py:186-189 (classes drawn at 1/8
    resolution, repeated ×8)."""
    im = rng.integers(0, 256, (b, h, w, 3)).astype(np.uint8)
    lb8 = rng.integers(0, n_classes, (b, h // 8, w // 8))
    return im, np.repeat(np.repeat(lb8, 8, 1), 8, 2).astype(np.uint8)


def phase_train(dev):
    """The train step at the config's batch and crop, bf16."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer

    cfg = Configer(config_file=CONFIG)
    n_classes = cfg.n_cats(0)
    b = int(cfg.dataset_cfg(0)["ims_per_gpu"])
    h, w = cfg.get("train", "cropsize")
    model = MODELS[cfg.get("model_name")](n_classes=(n_classes,), n_bn=1, aux=True,
                                          dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(WEIGHT_SEED)).to(dev)
    step, opt = train_step_for(cfg, model, torch.bfloat16)
    im, lb = seg_batch(np.random.default_rng(0), b, h, w, n_classes)
    ims, lbs = [torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)]
    gen = torch.Generator().manual_seed(0)
    p0 = {k: v.detach().clone() for k, v in model.named_parameters()}
    s0 = {k: v.clone() for k, v in model.named_buffers() if "running" in k}
    from mds_tpu_torch.ops import dropout

    metrics = [step(ims, lbs, gen)]  # warm-up
    # the dropout kernel's calls in one step (5 forward, 5 backward): their
    # bound reads each input once and writes each output once
    with captured(dropout, "dropout_u8",
                  lambda a: a.numel() * a.element_size() if torch.is_tensor(a) else None) as dc:
        metrics.append(step(ims, lbs, gen))
    drop_bytes = sum(2 * c[0] for c in dc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        metrics.append(step(ims, lbs, gen))
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"].item() for m in metrics]
    moved = sum(not torch.equal(p0[k], v) for k, v in model.named_parameters())
    stats_moved = sum(not torch.equal(s0[k], v) for k, v in model.named_buffers()
                      if "running" in k)
    idle = profile_idle_share(lambda: step(ims, lbs, gen), ("dropout_bf16_kernel",))
    step_ms = float(np.median(times))
    emit(phase="train", batch=[b, h, w], losses=losses,
         step_ms=times, median_step_ms=step_ms, images_per_s=b / step_ms * 1e3,
         max_memory_allocated=peak, params_moved=f"{moved}/{len(p0)}",
         bn_stats_moved=f"{stats_moved}/{len(s0)}", optimizer_steps=opt.count,
         launches=launches, dropout_calls_per_step=len(dc),
         dropout_step_bytes=drop_bytes,
         dropout_step_bound_ms=drop_bytes / HBM_BYTES_PER_S * 1e3, **idle)
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"non-finite train losses {losses}")
    if stats_moved != len(s0) or moved < 0.9 * len(p0):
        raise RuntimeError(f"train step moved {moved} params, {stats_moved} stats")
    want = {k: 0 for k in launches}
    want["dropout_u8"] = 10 * 5
    if launches != want:
        raise RuntimeError(f"train launches {launches}, expected {want}")
    return launches


def phase_train_stem(dev):
    """The train step with set_stem_impl("kernel") against the plain route
    from one set of weights and one batch; then stem_conv3x3_s2 at the inputs
    the steps gave it against its plain version and the library conv."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.ops import stem

    cfg = Configer(config_file=CONFIG)
    n_classes = cfg.n_cats(0)
    b = int(cfg.dataset_cfg(0)["ims_per_gpu"])
    h, w = cfg.get("train", "cropsize")
    im, lb = seg_batch(np.random.default_rng(6), b, h, w, n_classes)
    ims, lbs = [torch.from_numpy(im).to(dev)], [torch.from_numpy(lb).to(dev)]
    init = MODELS[cfg.get("model_name")](n_classes=(n_classes,), n_bn=1, aux=True,
                                         dtype=torch.bfloat16)
    init.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))

    def steps(stem_impl, n):
        model = copy.deepcopy(init).to(dev)
        step, _ = train_step_for(cfg, model, torch.bfloat16)
        with route(stem_impl), captured(stem, "stem_conv3x3_s2") as calls:
            reset_counts()
            out = []
            for i in range(n):
                out.append(step(ims, lbs, torch.Generator().manual_seed(i))["loss"].item())
                out.append(read_counts())
        return out, calls

    (plain_loss, plain_counts), _ = steps("plain", 1)
    torch.cuda.empty_cache()
    (loss1, counts1, loss2, launches), calls = steps("kernel", 2)
    torch.cuda.synchronize()
    want = {k: 0 for k in launches}
    want.update(dropout_u8=20, stem_conv3x3_s2=4)
    loss_rel = abs(loss1 - plain_loss) / abs(plain_loss)
    res = {"max_abs_err": 0.0, "ms": 0.0, "cold_ms": 0.0, "device_ms": 0.0,
           "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0, "library_bf16_ms": 0.0,
           "launches": launches["stem_conv3x3_s2"]}
    convs = []
    for x, k, packed in calls[:2]:  # the first step's two stems
        x, k = x.detach(), k.detach()
        got = stem.stem_conv3x3_s2(x, k, packed)
        want_y = stem.stem_conv3x3_s2_plain(x, k)
        lib_y = F.conv2d(x, k, stride=2, padding=1)
        g = torch.randn(got.shape, device=dev, generator=torch.Generator(dev).manual_seed(3)
                        ).to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
        grads = []
        for fn in (stem.stem_conv3x3_s2, lambda a, c: F.conv2d(a, c, stride=2, padding=1)):
            xg = x.clone().requires_grad_(True)
            kf = k.float().requires_grad_(True)  # as the model's f32 weight
            (fn(xg, kf.to(torch.bfloat16)) * g).sum().backward()
            grads.append((xg.grad, kf.grad))
        xf, kf = x.float(), k.float()
        rec = {"x": list(x.shape), "k": list(k.shape), "dtype": str(got.dtype),
               "rel": rel(got, want_y), "bit_equal": share_equal(bits(got), bits(want_y)),
               "rel_vs_library": rel(got, lib_y),
               "dx_rel": rel(grads[0][0], grads[1][0]),
               "dk_rel": rel(grads[0][1], grads[1][1]),
               "ms": cuda_ms(lambda: stem.stem_conv3x3_s2(x, k, packed)),
               "cold_ms": cuda_ms(lambda: stem.stem_conv3x3_s2(x, k)),
               "device_ms": device_ms(lambda: stem.stem_conv3x3_s2(x, k, packed),
                                      "stem_kernel"),
               "plain_ms": cuda_ms(lambda: stem.stem_conv3x3_s2_plain(x, k), n=5),
               # the same function (f32 out) in one call, TF32 off; and the
               # bf16 conv, the yardstick of the earlier bf16-output form
               "library_ms": cuda_ms(lambda: F.conv2d(xf, kf, stride=2, padding=1)),
               "library_bf16_ms": cuda_ms(lambda: F.conv2d(x, k, stride=2, padding=1))}
        rec["bound_ms"], res["bound_by"] = bound(nbytes(x, k, got), conv_flops(got, k))
        convs.append(rec)
        res["max_abs_err"] = max(res["max_abs_err"],
                                 (got.float() - want_y.float()).abs().max().item())
        for key in ("ms", "cold_ms", "device_ms", "plain_ms", "bound_ms", "library_ms",
                    "library_bf16_ms"):
            if isinstance(rec[key], float) and isinstance(res[key], float):
                res[key] += rec[key]
            else:
                res[key] = "not measured"
        if not (got.dtype == torch.float32 and torch.isfinite(got).all()
                and rec["rel"] <= F32_GATE and max(
                    rec["rel_vs_library"], rec["dx_rel"], rec["dk_rel"]) < KERNEL_GATE):
            raise RuntimeError(f"stem_conv3x3_s2: {rec}")
    emit(phase="train_stem", batch=[b, h, w], plain_loss=plain_loss,
         kernel_losses=[loss1, loss2], loss_rel=loss_rel,
         plain_launches=plain_counts, first_step_launches=counts1,
         launches=launches, convs=convs,
         library="f32 F.conv2d, TF32 off (library_bf16_ms: bf16 F.conv2d); "
                 "gradients against bf16 F.conv2d's autograd")
    if not np.isfinite([plain_loss, loss1, loss2]).all() or loss_rel >= 1e-2:
        raise RuntimeError(f"train_stem: losses {plain_loss} vs {loss1}, {loss2}")
    if launches != want or counts1["stem_conv3x3_s2"] != 2:
        raise RuntimeError(f"train_stem launches {launches}, expected {want}")
    return res


def profile_idle_share(fn, kernels_of_interest=()):
    """Device busy time and idle share of one call under torch.profiler, or
    "not measured" where the profiler sees no device time; beside the top
    ten, the summed device time and launches of each kernel named in
    `kernels_of_interest`."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device activity, without the annotation ranges drawn over it
    kernels_ = [e for e in prof.events()
                if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    busy_ms = sum(e.device_time_total for e in kernels_) / 1e3  # µs → ms
    if busy_ms <= 0:
        return {"profiled_wall_ms": wall_ms, "idle_share": "not measured"}
    by_name = {}
    for e in kernels_:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time_total / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    named = {k: {"device_ms": sum(e.device_time_total for e in kernels_ if k in e.name) / 1e3,
                 "launches": sum(k in e.name for e in kernels_)}
             for k in kernels_of_interest}
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_launches": len(kernels_), "idle_share": 1 - busy_ms / wall_ms,
            "top_device_ms": [[n[:80], ms] for n, ms in top], "kernel_device_ms": named}


def phase_parity(dev):
    """One f32 train step with dropout on, on the card and on the CPU, from
    the same weights and generator seed: the card's kernels and library ops
    against the CPU path that tests/test_torch_train.py holds to JAX."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer

    cfg = Configer(config_file=CONFIG)
    n_classes = cfg.n_cats(0)
    # batch 4: the CEBlock's BN over 2 images' global pools would make the
    # gradients rounding-chaotic (tests/test_torch_train.py)
    im, lb = seg_batch(np.random.default_rng(3), 4, 64, 128, n_classes)
    gain = np.random.default_rng(4).uniform(0.2, 1.0, (4, 1, 1, 1))
    im = (im * gain).astype(np.uint8)  # images of distinct global statistics
    cpu = MODELS[cfg.get("model_name")](n_classes=(n_classes,), n_bn=1, aux=True)
    cpu.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
    runs = {}
    for name, model, d in (("cuda", copy.deepcopy(cpu).to(dev), dev), ("cpu", cpu, "cpu")):
        step, opt = train_step_for(cfg, model, torch.float32)
        reset_counts()
        loss = step([torch.from_numpy(im).to(d)], [torch.from_numpy(lb).to(d)],
                    torch.Generator().manual_seed(5))["loss"].item()
        groups = {id(p): g["name"] for g in opt.param_groups for p in g["params"]}
        named = dict(model.named_parameters())  # .grad: the step's gradient
        runs[name] = {"loss": loss, "launches": read_counts()["dropout_u8"],
                      "grads": {k: p.grad.cpu().double() for k, p in named.items()},
                      "group": {k: groups[id(p)] for k, p in named.items()},
                      "params": {k: p.detach().cpu() for k, p in named.items()}}
    a, b = runs["cuda"], runs["cpu"]
    loss_rel = abs(a["loss"] - b["loss"]) / abs(b["loss"])
    cos = {}
    for g in ("wd", "nowd", "head_wd", "head_nowd"):
        ks = [k for k in a["grads"] if a["group"][k] == g]
        va = torch.cat([a["grads"][k].flatten() for k in ks])
        vb = torch.cat([b["grads"][k].flatten() for k in ks])
        cos[g] = (va @ vb / (va.norm() * vb.norm())).item()
    # per group: a zero-initialized bias whose gradient a train-mode BN
    # cancels moves by rounding noise alone, so no tensor stands alone
    param_rel = max(
        max((a["params"][k] - b["params"][k]).abs().max().item() for k in ks)
        / max(b["params"][k].abs().max().item() for k in ks)
        for ks in ([k for k in a["params"] if a["group"][k] == g]
                   for g in ("wd", "nowd", "head_wd", "head_nowd")))
    pool = avg_pool_backward_check(dev)
    emit(phase="parity", loss_cuda=a["loss"], loss_cpu=b["loss"], loss_rel=loss_rel,
         grad_cosine=cos, param_rel=param_rel,
         dropout_launches={"cuda": a["launches"], "cpu": b["launches"]},
         avg_pool2d_channels_last_grad_rel_l2=pool)
    if pool["port"] > 1e-5:
        raise RuntimeError(f"parity: the port's avg pool gradient disagrees {pool}")
    if a["launches"] != 10 or b["launches"] != 0:
        raise RuntimeError("parity: the card's step did not run the dropout kernel")
    if loss_rel >= 1e-4 or min(cos.values()) <= 0.9999 or param_rel >= 1e-4:
        raise RuntimeError("parity: the card's train step disagrees with the CPU's")


def avg_pool_backward_check(dev):
    """PyTorch's avg_pool2d backward on a channels_last input, the card
    against the CPU (relative L2): layers.avg_pool_3x3_s2 pools an NCHW copy
    under autograd while the card's is wrong; when `raw` reads ~1e-7, the
    copy can go. `port` is the port's pool, which must agree."""
    from mds_tpu_torch.models.layers import avg_pool_3x3_s2

    x = torch.randn(4, 16, 32, 64, generator=torch.Generator().manual_seed(0))
    r = torch.randn(4, 16, 16, 32, generator=torch.Generator().manual_seed(1))
    out = {}
    for name, fn in (("raw", lambda t: F.avg_pool2d(t, 3, 2, 1, count_include_pad=True)),
                     ("port", avg_pool_3x3_s2)):
        grads = []
        for d in (dev, "cpu"):
            t = x.to(d).contiguous(memory_format=torch.channels_last).requires_grad_(True)
            (fn(t) * r.to(d)).sum().backward()
            grads.append(t.grad.cpu().double())
        out[name] = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    return out


def randomize_bn(model, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                n = m.num_features
                m.running_mean.copy_(torch.randn(n, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(n, generator=gen) + 0.5)


@contextlib.contextmanager
def route(stem_impl="plain", fuse=False, depthwise="plain", pred="plain",
          tail=False, conv3="plain", stem_variant="tiles"):
    """The layers' route switches set for the block; the plain path after."""
    from mds_tpu_torch.models.layers import (
        set_conv3_eval_impl,
        set_depthwise_impl,
        set_detail_fuse,
        set_detail_tail,
        set_pred_impl,
        set_stem_impl,
    )
    from mds_tpu_torch.ops.stem import set_stem_variant

    set_stem_impl(stem_impl)
    set_detail_fuse(fuse)
    set_depthwise_impl(depthwise)
    set_pred_impl(pred)
    set_detail_tail(tail)
    set_conv3_eval_impl(conv3)
    set_stem_variant(stem_variant)
    try:
        yield
    finally:
        set_stem_impl("plain")
        set_detail_fuse(False)
        set_depthwise_impl("plain")
        set_pred_impl("plain")
        set_detail_tail(False)
        set_conv3_eval_impl("plain")
        set_stem_variant("tiles")


# BiSeNetV2's served route: every deploy kernel on (tools/serve_torch.py)
ALL_ROUTES = {"stem_impl": "kernel", "fuse": True, "depthwise": "kernel",
              "pred": "fused", "tail": True}
NO_TAIL_ROUTES = {**ALL_ROUTES, "tail": False}  # every deploy route but the tail
STEM_FUSED_ROUTES = {"stem_impl": "kernel", "fuse": True}
# the segment.py route with the window stem and the conv3 kernel: the two
# RGB stems on kernel 2, DetailBranch S1_2 on kernel 8
STEM_DMA_CONV3_ROUTES = {"stem_impl": "kernel", "stem_variant": "dma",
                         "conv3": "kernel"}


def normalized(e2e, frame):
    """One uint8 (1, H, W, 3) frame as the model's bf16 NCHW input."""
    x = torch.from_numpy(frame).to(e2e.mean.device).float() / 255.0
    return ((x - e2e.mean) / e2e.std).to(torch.bfloat16).permute(0, 3, 1, 2)


def serve_and_check(e2e, name, frames, n_classes, **route_kw):
    """`frames` as requests to InferenceServer on 127.0.0.1 under the route,
    after one frame that warms up cuDNN's algorithm choice (not counted):
    the kernel launches of the requests, their latencies, the label maps
    checked for shape, range and more than one class (a constant map would
    agree with anything), and each map's agreement with the same model on
    the plain path (library ops, no kernels)."""
    from mds_tpu_torch.deploy.server import InferenceServer

    srv = InferenceServer(e2e, (H, W), name=name)
    httpd = srv.serve_background(0, "127.0.0.1")
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v2/models/{name}/infer"
    try:
        with route(**route_kw):
            e2e.infer(frames[0])
            reset_counts()
            replies, latency_ms = [], []
            for fr in frames:
                t0 = time.perf_counter()
                with urllib.request.urlopen(
                        urllib.request.Request(url, data=fr.tobytes()), timeout=300) as r:
                    shape = json.loads(r.headers["X-Shape"])
                    replies.append(np.frombuffer(r.read(), np.int32).reshape(shape))
                latency_ms.append((time.perf_counter() - t0) * 1e3)
            launches = read_counts()
    finally:
        httpd.shutdown()
        httpd.server_close()
    classes = []
    for rep in replies:
        if rep.shape != (1, H, W) or rep.dtype != np.int32:
            raise RuntimeError(f"{name}: bad reply {rep.shape} {rep.dtype}")
        if rep.min() < 0 or rep.max() >= n_classes:
            raise RuntimeError(f"{name}: labels out of range [{rep.min()}, {rep.max()}]")
        classes.append(int(np.unique(rep).size))
    if min(classes) < 2:
        raise RuntimeError(f"{name}: degenerate label maps: {classes} classes")
    plain = [e2e.infer(fr) for fr in frames]
    return {"launches": launches, "latency_ms": latency_ms, "classes": classes,
            "replies": replies, "plain_labels": plain,
            "agree": [float((rep == ref).mean()) for rep, ref in zip(replies, plain)]}


def logits_rels(model, x, n_classes, routes):
    """The rel max-diff of the model's logits of `x` on each route against
    the plain path; every logits tensor checked for shape and finiteness."""
    with torch.inference_mode():
        ref = model.eval_logits(x)
        outs = []
        for kw in routes:
            with route(**kw):
                outs.append(model.eval_logits(x))
    for t in (ref, *outs):
        if t.shape != (1, n_classes, H, W) or not torch.isfinite(t.float()).all():
            raise RuntimeError(f"bad logits {t.shape}")
    return [rel(t, ref) for t in outs]


def e2e_ms(e2e, frame, **route_kw):
    """E2EModel time per frame alone (no HTTP) on the route: CUDA events,
    median of 10."""
    with route(**route_kw):
        return cuda_ms(lambda: e2e(torch.from_numpy(frame)), n=10)


def v2_model(dev):
    """BiSeNetV2 as configs/bisenetv2_city.json serves it (19 classes, bf16,
    no aux heads), seeded weights with random BN statistics, in an E2EModel
    on the card; and the phase's three 1024×2048 uint8 frames."""
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.deploy.e2e import E2EModel

    cfg = Configer(config_file=CONFIG)
    spec = get_spec(cfg.dataset_cfg(0)["spec"])
    model = MODELS[cfg.get("model_name")](n_classes=(cfg.n_cats(0),), n_bn=1,
                                          aux=False, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(WEIGHT_SEED))
    randomize_bn(model, WEIGHT_SEED + 1)
    frames = np.random.default_rng(2).integers(0, 256, (3, 1, H, W, 3)).astype(np.uint8)
    return E2EModel(model, spec.mean, spec.std, device=dev), frames


def fused_tail_reference(model, x):
    """The plain route's head logits (library ops, head resolution) through
    the fused tail's plain version, which rounds where the kernel does."""
    from mds_tpu_torch.models.layers import as_multi
    from mds_tpu_torch.ops.upsample_argmax import upsample_argmax_plain

    with torch.inference_mode():
        feat, _ = model.backbone(as_multi(x, 0, model.n_bn))
        head = model.head[0]
        logits = head(feat[0], up=False)
        return upsample_argmax_plain(logits, head.residual_factor).cpu().numpy()


def phase_slice(dev, e2e, frames):
    """BiSeNetV2 served with every deploy route on (stem kernel, detail
    fusion and tail, depthwise kernel, fused pred), then one frame on the
    stem-kernel route alone and one on it with the window stem and the conv3
    kernel, against the same model on the plain path."""
    model = e2e.model
    n_classes = model.n_classes[0]
    served = serve_and_check(e2e, "bisenetv2", frames, n_classes, **ALL_ROUTES)
    launches = dict(served["launches"])
    # the segment.py route: stem kernels, no detail/StemBlock fusion; then
    # the same with the window stem (kernel 2) and the conv3 kernel (8)
    stem_labels = {}
    for key, kw in (("stem", {"stem_impl": "kernel"}),
                    ("stem_dma_conv3", STEM_DMA_CONV3_ROUTES)):
        with route(**kw):
            reset_counts()
            stem_labels[key] = e2e.infer(frames[0])
            got = read_counts()
        launches = {k: launches[k] + n for k, n in got.items()}
    want = {k: 0 for k in launches}
    want.update(detail_s1s2_fused=3, stemblock_fused=3, detail_tail_fused=3,
                stem_conv_bn_relu_s2=2, stem_conv_bn_relu_s2_window=2,
                conv3x3_bn_relu=1, depthwise3x3=16 * len(frames),
                upsample_argmax=len(frames))
    if launches != want:
        raise RuntimeError(f"kernel launches {launches}, expected {want}")
    # the fused tail rounds the vertical pass to bf16 by design, as JAX's
    # does: the served labels are held to the plain route's head logits put
    # through the tail's plain version, and their agreement with the plain
    # route's F.interpolate + argmax labels is reported without a gate
    agree = [float((rep == fused_tail_reference(model, normalized(e2e, fr))).mean())
             for rep, fr in zip(served["replies"], frames)]
    agree_interp = served["agree"]
    agree_stem = {k: float((v == served["plain_labels"][0]).mean())
                  for k, v in stem_labels.items()}
    rel_all, rel_dw, rel_stem, rel_dma = logits_rels(
        model, normalized(e2e, frames[0]), n_classes,
        ({**ALL_ROUTES, "pred": "plain"}, {"depthwise": "kernel"},
         {"stem_impl": "kernel"}, STEM_DMA_CONV3_ROUTES))
    # in turns: all routes, all but the tail, stem fusion, the stem route,
    # the stem route with the window stem and conv3, plain; then backwards
    order = (("all", ALL_ROUTES), ("no_tail", NO_TAIL_ROUTES),
             ("stem_fused", STEM_FUSED_ROUTES), ("stem", {"stem_impl": "kernel"}),
             ("stem_dma_conv3", STEM_DMA_CONV3_ROUTES), ("plain", {}))
    e2e_times = {k: [] for k, _ in order}
    for k, kw in order + order[::-1]:
        e2e_times[k].append(e2e_ms(e2e, frames[1], **kw))
    # stem_kernel: kernel 1, or kernel 2 on the window-stem route
    of_interest = ("dw3x3_kernel", "upsample_argmax_kernel", "stem_kernel",
                   "detail_head_kernel", "stemblock_kernel", "detail_tail_kernel",
                   "conv3x3_kernel")
    profiles = {}
    for k, kw in order:
        with route(**kw):
            profiles[k] = profile_idle_share(
                lambda: e2e(torch.from_numpy(frames[1])), of_interest)
    emit(phase="slice", requests=len(frames), latency_ms=served["latency_ms"],
         classes_per_reply=served["classes"],
         argmax_agreement=agree, argmax_agreement_interpolate=agree_interp,
         logits_rel=rel_all, depthwise_route_logits_rel=rel_dw,
         stem_route_agreement=agree_stem, stem_route_logits_rel=rel_stem,
         stem_dma_conv3_route_logits_rel=rel_dma,
         e2e_ms=e2e_times, launches=launches, profile=profiles)
    if min(agree + list(agree_stem.values())) <= ARGMAX_GATE:
        raise RuntimeError(f"argmax agreement {agree} / {agree_stem}")
    if max(rel_all, rel_dw, rel_stem, rel_dma) >= LOGITS_GATE:
        raise RuntimeError(f"logits rel {rel_all} / {rel_dw} / {rel_stem} / {rel_dma}")
    return launches


def phase_v1_slice(dev):
    """BiSeNetV1 served as tools/serve_torch.py serves it, the 7×7 stems on
    their kernel, against the same model on the plain path."""
    from mds_tpu_torch.config import Configer

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    from serve_torch import build_e2e

    cfg = Configer(config_file=V1_CONFIG)
    name, n_classes = cfg.get("model_name"), cfg.n_cats(0)
    e2e = build_e2e(V1_CONFIG, seed=V1_WEIGHT_SEED, device=dev)
    randomize_bn(e2e.model, V1_WEIGHT_SEED + 1)
    frames = np.random.default_rng(4).integers(0, 256, (3, 1, H, W, 3)).astype(np.uint8)

    served = serve_and_check(e2e, name, frames, n_classes, stem_impl="kernel")
    launches = served["launches"]
    want = {k: 0 for k in launches}
    want["stem7_conv_bn_relu_s2"] = 2 * len(frames)
    if launches != want:
        raise RuntimeError(f"v1 kernel launches {launches}, expected {want}")
    agree = served["agree"]
    (logits_rel,) = logits_rels(e2e.model, normalized(e2e, frames[0]), n_classes,
                                ({"stem_impl": "kernel"},))
    # in turns: kernel, plain, plain, kernel
    kernel_ms, plain_ms = e2e_ms(e2e, frames[1], stem_impl="kernel"), e2e_ms(e2e, frames[1])
    plain_ms2, kernel_ms2 = e2e_ms(e2e, frames[1]), e2e_ms(e2e, frames[1], stem_impl="kernel")
    profiles = {}
    for impl in ("kernel", "plain"):
        with route(impl):
            profiles[impl] = profile_idle_share(
                lambda: e2e(torch.from_numpy(frames[1])), ("stem7_kernel",))
    emit(phase="v1_slice", config=os.path.relpath(V1_CONFIG, ROOT),
         requests=len(frames), latency_ms=served["latency_ms"],
         classes_per_reply=served["classes"],
         argmax_agreement=agree, logits_rel=logits_rel,
         e2e_kernel_ms=[kernel_ms, kernel_ms2], e2e_plain_ms=[plain_ms, plain_ms2],
         launches=launches, profile=profiles)
    if min(agree) <= ARGMAX_GATE:
        raise RuntimeError(f"v1 argmax agreement {agree}")
    if logits_rel >= LOGITS_GATE:
        raise RuntimeError(f"v1 logits rel {logits_rel}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, ROOT)
    from mds_tpu_torch.ops import build

    dev = "cuda"
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    emit(phase="device", name=name, count=torch.cuda.device_count(),
         nvidia_smi=smi, torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    lib = build.build()
    build.load()
    emit(phase="build", seconds=time.perf_counter() - t0, library=lib.name)
    sass_check(lib)

    # the plain references run cuDNN convs in full f32 (TF32 off)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    results = phase_kernels(dev)
    e2e, frames = v2_model(dev)
    dw_calls, ua_calls, tail_calls, c3_calls = main_path_inputs(e2e, frames[0])
    counts = [len(c) for c in (dw_calls, ua_calls, tail_calls, c3_calls)]
    if counts != [16, 1, 1, 1]:
        raise RuntimeError(f"a V2 frame made {counts} depthwise, fused-tail, "
                           "detail-tail and conv3 calls, expected 16, 1, 1, 1")
    results.update(depthwise_rows(dw_calls))
    results["upsample_argmax"] = upsample_argmax_row(ua_calls[0])
    results["detail_tail_fused"] = detail_tail_row(
        tail_calls[0], e2e.model.detail, normalized(e2e, frames[0]))
    results["conv3x3_bn_relu"] = conv3x3_row(c3_calls[0])
    del dw_calls, ua_calls, tail_calls, c3_calls
    emit(phase="kernels", ragged=new_kernels_ragged(dev))
    emit(phase="kernels", ragged=conv_kernels_ragged(dev))
    results["dropout_u8"] = phase_dropout(dev)
    torch.cuda.empty_cache()
    launches = phase_slice(dev, e2e, frames)
    del e2e
    launches["stem7_conv_bn_relu_s2"] = phase_v1_slice(dev)["stem7_conv_bn_relu_s2"]
    torch.cuda.empty_cache()
    launches["dropout_u8"] = phase_train(dev)["dropout_u8"]
    torch.cuda.empty_cache()
    results["stem_conv3x3_s2"] = phase_train_stem(dev)
    launches["stem_conv3x3_s2"] = results["stem_conv3x3_s2"]["launches"]
    torch.cuda.empty_cache()
    phase_parity(dev)
    emit(kernels=[{
        "name": k, "route": "cuda", "source": src, "replaces": tpu,
        "launches": launches[k], "max_abs_err": results[k]["max_abs_err"],
        "ms": results[k]["ms"], "plain_ms": results[k]["plain_ms"],
        "bound_ms": results[k]["bound_ms"], "bound_by": results[k]["bound_by"],
        "library_ms": results[k]["library_ms"],
    } for k, (src, tpu) in SOURCES.items()])
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    main()
