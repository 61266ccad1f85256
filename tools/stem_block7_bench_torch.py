#!/usr/bin/env python
"""Kernels 5 (csrc/stem.cu: the BiSeNetV2 StemBlock) and 6 (csrc/stem7.cu:
BiSeNetV1's 7×7 RGB stem) on a CUDA card, at the served frames' shapes.

  python tools/stem_block7_bench_torch.py [--tree DIR] [--no-split]

Each kernel at (1, 3, 1024, 2048) (kernel 6 → 64 channels) and at ragged
shapes (B > 1, H/4, W/4 or W/2 off the tiles, the smallest image, kernel 6 at
O from 8 to 128) against its plain version: rel max-diff, bit-equal share,
and the share bit-equal to the plain version with its convs summed in f64
(the rounding points the kernel keeps, exact sums). At the frame: timed warm
on its packed weights (where the tree packs once), cold (packing in the
call), both as the median of 20 CUDA-event runs, by its device time
(torch.profiler, mean of 10), beside its bound (bytes over 3.35 TB/s or
operations over 989 TFLOP/s, the larger) and, for kernel 6, bf16 F.conv2d's
time (the library's one call for the same conv). One JSON line per shape.

Then the split: the tree's csrc built again with one part of a kernel taken
out at a time, each variant's device time at the frame shape, into the
git-ignored mds_tpu_torch/build/sb7_bench/ of the tree. Kernel 5: no window
loads, no stem (its MMAs, then the whole stage), no left_1 MMA, no concat
row (maxpool and left_2), no maxpool, no fuse, one or two blocks an SM.
Kernel 6: no MMA, no stores (the bulk copies out), no window loads, no
stmatrix epilogue, three blocks an SM at O = 64. What a part costs is the built kernel's time less its
variant's (the parts overlap; the differences need not add up, and a
variant's numbers are wrong by design). A variant with a wgmma under a
condition serializes every wgmma of the kernel (ptxas C7520), which
inflates it. The ptxas lines (registers, spills, serialization) of both
kernels come first.

--tree DIR times another checkout's wrappers (its mds_tpu_torch, built
there), for a comparison within one call: run parent, change, change, parent.
The card's name, power limit and SM clock close the output.
"""

import argparse
import ctypes
import inspect
import json

import numpy as np
import torch
import torch.nn.functional as F

from bench_util_torch import (BF16_FLOP_PER_S, HBM_BYTES_PER_S, bit_equal, build_variants,
                              built, cuda_ms, device_ms, exact_plain, open_tree, print_card,
                              ptxas_lines, rel)

FRAME = (1, 1024, 2048)
SB_RAGGED = ((2, 20, 252), (1, 4, 4), (2, 36, 260), (1, 8, 492))
S7_RAGGED = ((2, 18, 70, 32), (1, 64, 130, 128), (3, 2, 2, 8), (1, 100, 66, 24),
             (2, 36, 44, 64))


def conv_w(rng, o, i, ks, dev):
    return torch.tensor(rng.normal(0, np.sqrt(2 / (o * ks * ks)), (o, i, ks, ks)),
                        dtype=torch.float32, device=dev)


def bn(rng, o, dev):
    g, be = rng.normal(1, 0.1, o), rng.normal(0, 0.1, o)
    m, v = rng.normal(0, 0.1, o), rng.uniform(0.5, 1.5, o)
    s = g / np.sqrt(v + 1e-5)
    return (torch.tensor(s, dtype=torch.float32, device=dev),
            torch.tensor(be - m * s, dtype=torch.float32, device=dev))


def image(rng, b, h, w, dev):
    return torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                        device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)


def sb_args(rng, b, h, w, dev):
    return (image(rng, b, h, w, dev), conv_w(rng, 16, 3, 3, dev), *bn(rng, 16, dev),
            conv_w(rng, 8, 16, 1, dev), *bn(rng, 8, dev), conv_w(rng, 16, 8, 3, dev),
            *bn(rng, 16, dev), conv_w(rng, 16, 32, 3, dev), *bn(rng, 16, dev))


def s7_args(rng, b, h, w, o, dev):
    return (image(rng, b, h, w, dev), conv_w(rng, o, 3, 7, dev), *bn(rng, o, dev), True)


def sb_packed(stem, args):
    return stem.pack_stemblock(*args[1:]) if hasattr(stem, "pack_stemblock") else None


def s7_packed(stem, args):
    return stem.pack_stem7(*args[1:4]) if hasattr(stem, "pack_stem7") else None


def measure(stem, name, shapes, make, pack, key, flops, library=None):
    """`name`'s wrapper at each shape against its plain version; timed at
    the first (the frame)."""
    fn, plain = getattr(stem, name), getattr(stem, name + "_plain")
    warm = "packed" in inspect.signature(fn).parameters
    rng = np.random.default_rng(0)
    for i, shape in enumerate(shapes):
        args = make(rng, *shape)
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        row = {"kernel": name, "shape": list(shape), "rel": rel(got, want),
               "bit_equal": bit_equal(got, want),
               "bit_equal_f64": bit_equal(got, exact_plain(stem, plain, args)),
               "plain_bit_equal_f64": bit_equal(want, exact_plain(stem, plain, args)),
               "finite": bool(torch.isfinite(got.float()).all())}
        if i == 0:
            kw = {"packed": pack(stem, args)} if warm else {}
            row["cold_ms"] = cuda_ms(lambda: fn(*args))
            row["ms"] = cuda_ms(lambda: fn(*args, **kw)) if warm else row["cold_ms"]
            row["device_ms"] = device_ms(lambda: fn(*args, **kw), key)
            row["plain_ms"] = cuda_ms(lambda: plain(*args), n=5)
            byts = sum(t.numel() * t.element_size() for t in args
                       if torch.is_tensor(t)) + got.numel() * 2
            row["bound_ms"] = max(flops(args, got) / BF16_FLOP_PER_S,
                                  byts / HBM_BYTES_PER_S) * 1e3
            if library:
                row["library_ms"] = cuda_ms(library(args))
        print(json.dumps(row), flush=True)


def sb_flops(args, got):
    b, _, h, w = args[0].shape
    p2, p4 = b * (h // 2) * (w // 2), b * (h // 4) * (w // 4)
    return 2 * p2 * (16 * 27 + 8 * 16) + 2 * p4 * 16 * (72 + 288)


def s7_library(args):
    x, k, scale, bias = args[:4]
    wf = (k * scale.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
    bf = bias.to(torch.bfloat16)
    return lambda: F.conv2d(x, wf, bf, stride=2, padding=3)


# ------------------------------------------------------------- the split

# (file, anchor, replacement): a variant applies where its anchors are found
SB_VARIANTS = {
    "no_window": [("stem.cu", "    if (fvalid) sb_window(buf,", "    if (H < 0) sb_window(buf,")],
    "no_stem_mma": [("stem.cu", "      wgmma_m64n16k16(acc[i], a[i][step & 1],",
                     "      if (H < 0) wgmma_m64n16k16(acc[i], a[i][step & 1],")],
    "no_left1_mma": [("stem.cu", "for (int i = 0; i < 4; ++i) wgmma_m64n16k16(acc1[i]",
                      "for (int i = 0; i < 4 * (H < 0); ++i) wgmma_m64n16k16(acc1[i]")],
    "no_stem": [("stem.cu", "      sb_stem_rows(wins", "      if (H < 0) sb_stem_rows(wins")],
    "no_concat": [("stem.cu", "      if (u >= g.qa - 1) sb_concat(",
                   "      if (H < 0) sb_concat(")],
    "no_maxpool": [("stem.cu", "  if (threadIdx.x < 2 * kSbC) {", "  if (H4 < 0) {")],
    "no_fuse": [("stem.cu", "      if (u > g.qa) sb_fuse(", "      if (H < 0) sb_fuse(")],
    "one_per_sm": [("stem.cu", "constexpr int kSbMaxPerSm = 3;",
                    "constexpr int kSbMaxPerSm = 1;")],
    "two_per_sm": [("stem.cu", "constexpr int kSbMaxPerSm = 3;",
                    "constexpr int kSbMaxPerSm = 2;")],
}
S7_VARIANTS = {
    "no_mma": [("stem7.cu", "      wgmma_m64nk16<N>(acc, a[s], sw128_desc(",
                "      if (H < 0) wgmma_m64nk16<N>(acc, a[s], sw128_desc(")],
    "no_store": [("stem7.cu", "  bulk_s2g(out + ", "  if (H2 < 0) bulk_s2g(out + ")],
    "no_window": [("stem7.cu", "    if (y < 0 || y >= H) {", "    if (H > 0) {")],
    "no_epilogue": [("stem7.cu", "      const int n = min(4, nv - j4);",
                     "      const int n = O < 0 ? min(4, nv - j4) : 2;"),
                    ("stem7.cu", "if (n >= 2) stmatrix_x2(", "if (O < 0) stmatrix_x2(")],
    "three_per_sm": [("stem7.cu", "__launch_bounds__(k7Threads, N <= 64 ? 4 : 2)",
                      "__launch_bounds__(k7Threads, N <= 32 ? 4 : N == 64 ? 3 : 2)")],
}


def split(tree, stem, dev):
    if not hasattr(stem, "pack_stemblock") or not hasattr(stem, "pack_stem7"):
        return  # a tree before these packs: its launchers take other weights
    out_dir = tree / "mds_tpu_torch" / "build" / "sb7_bench"
    jobs = {"stemblock": build_variants("stem.cu", {"built": [], **SB_VARIANTS},
                                        out_dir / "sb"),
            "stem7": build_variants("stem7.cu", {"built": [], **S7_VARIANTS}, out_dir / "s7")}
    P, I = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    rng = np.random.default_rng(0)
    sb = sb_args(rng, *FRAME, dev)
    s7 = s7_args(rng, *FRAME, 64, dev)
    b, _, h, w = sb[0].shape
    sbw, sbb = stem.pack_stemblock(*sb[1:])
    s7w = stem.pack_stem7(*s7[1:4])
    sb_out = torch.empty((b, 16, h // 4, w // 4), dtype=torch.bfloat16, device=dev,
                         memory_format=torch.channels_last)
    s7_out = torch.empty((b, 64, h // 2, w // 2), dtype=torch.bfloat16, device=dev,
                         memory_format=torch.channels_last)
    for kernel, procs in jobs.items():
        times = {}
        for name, p in procs.items():
            log = built(f"{kernel} {name}", p)
            if name == "built":
                print(json.dumps({"ptxas": kernel, "lines": ptxas_lines(
                    log, "stemblock_kernel" if kernel == "stemblock" else "stem7_kernel")}),
                    flush=True)
            lib = ctypes.CDLL(str(out_dir / ("sb" if kernel == "stemblock" else "s7")
                                  / name / "lib.so"))
            if kernel == "stemblock":
                fn = lib.mds_stemblock_fused
                fn.argtypes = [P] * 4 + [I] * 3 + [P]
                call_args = lambda: (ptr(sb[0]), ptr(sbw), ptr(sbb), ptr(sb_out), b, h, w,  # noqa: E731
                                     stream())
            else:
                fn = lib.mds_stem7_conv_bn_relu_s2
                fn.argtypes = [P] * 3 + [I] * 5 + [P]
                call_args = lambda: (ptr(s7[0]), ptr(s7w), ptr(s7_out), b, h, w, 64, 1,  # noqa: E731
                                     stream())

            def call():
                err = fn(*call_args())
                if err:
                    raise RuntimeError(f"{kernel} {name}: launch failed ({err})")

            times[name] = device_ms(call, "stemblock_kernel" if kernel == "stemblock"
                                    else "stem7_kernel")
        print(json.dumps({"split": kernel, "device_ms": times}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="time another checkout's mds_tpu_torch")
    ap.add_argument("--no-split", action="store_true", help="skip the split")
    args = ap.parse_args()
    tree = open_tree(args.tree, "stem_block7_bench_torch")
    from mds_tpu_torch.ops import stem

    dev = "cuda"
    measure(stem, "stemblock_fused", (FRAME,) + SB_RAGGED,
            lambda rng, *s: sb_args(rng, *s, dev), sb_packed, "stemblock_kernel", sb_flops)
    measure(stem, "stem7_conv_bn_relu_s2", ((*FRAME, 64),) + S7_RAGGED,
            lambda rng, *s: s7_args(rng, *s, dev), s7_packed, "stem7_kernel",
            lambda a, got: 2 * got.numel() * a[1][0].numel(), s7_library)
    if not args.no_split:
        split(tree, stem, dev)
    print_card()


if __name__ == "__main__":
    main()
