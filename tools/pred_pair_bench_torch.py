#!/usr/bin/env python
"""Kernels 3 (csrc/stem.cu pair_kernel: DetailBranch S1_1 -> S1_2) and 11
(csrc/upsample_argmax.cu: the fused x8 upsample + argmax of BiSeNetV2's
served pred tail) on a CUDA card.

  python tools/pred_pair_bench_torch.py [--tree DIR] [--no-split]

Kernel 3 at (1, 3, 1024, 2048) and at ragged shapes (B = 2, two and three
strips with a narrow last one, the smallest image, without the second ReLU)
against its plain version: rel max-diff, bit-equal share, and the share
bit-equal to the plain version with its convs summed in f64 (the rounding
points the kernel keeps, exact sums). At the frame: timed warm on its packed
weights (where the tree packs once), cold (packing in the call), both as
the median of 20 CUDA-event runs, by its device time (torch.profiler, mean
of 10), beside its plain version and its bound (operations over 989 TFLOP/s
or bytes over 3.35 TB/s, the larger).

Kernel 11 at the served frame's logits shape (1, 19, 128, 256) bf16, s = 8,
on seeded normal logits, and at ragged shapes (odd h and w, B = 2, C = 1 to
150, s = 1, 3, 5, 8, bf16 and f32): the pixels that differ from its plain
version (0 expected: the two round alike). At the frame: the wrapper's ms,
its device time, the plain version's ms and the bound (bytes over 3.35
TB/s or its f32 operations over 67 TFLOP/s, the larger). One JSON line per
shape.

Then the split: the tree's csrc built again with one part of a kernel taken
out at a time, each variant's device time at the frame, into the git-ignored
mds_tpu_torch/build/pp_bench/ of the tree. Kernel 3: no S1_1 stage, no S1_2
MMAs, no bulk stores, no input windows. Kernel 11: no label stores (the
compute kept alive), no argmax (a sum in its place), no staging of the
logits or of the weight table, the bf16 lerp in three operations instead of
the FMA form; and other shapes of it: four blocks an SM (more registers),
one row a thread, at six or eight blocks an SM. What a
part costs is the built kernel's time less its variant's (the parts
overlap; a variant's numbers are wrong by design; a wgmma under a condition
serializes every wgmma of the kernel, ptxas C7520, which inflates it). The
ptxas lines (registers, spills, serialization) of both kernels come first.

--tree DIR times another checkout's wrappers (its mds_tpu_torch, built
there), for a comparison within one call: run parent, change, change,
parent. The card's name, power limit and SM clock close the output.
"""

import argparse
import ctypes
import inspect
import json

import numpy as np
import torch

from bench_util_torch import (BF16_FLOP_PER_S, HBM_BYTES_PER_S, bit_equal, build_variants,
                              built, cuda_ms, device_ms, exact_plain, open_tree, print_card,
                              ptxas_lines, rel)

F32_FLOP_PER_S = 67e12  # CUDA cores, outside the tensor cores
FRAME = (1, 1024, 2048)
PAIR_RAGGED = ((2, 18, 70, True), (2, 10, 262, True), (1, 2, 2, True),
               (1, 8, 508, False))
LOGITS = (1, 19, 128, 256, 8, torch.bfloat16)
UA_RAGGED = ((2, 19, 13, 37, 8, torch.bfloat16), (1, 1, 9, 13, 8, torch.bfloat16),
             (1, 150, 15, 9, 8, torch.bfloat16), (2, 19, 7, 9, 5, torch.bfloat16),
             (1, 19, 9, 71, 1, torch.bfloat16), (1, 19, 5, 7, 3, torch.float32),
             (2, 19, 17, 35, 8, torch.float32))


def pair_args(rng, b, h, w, relu2, dev):
    def conv(o, i):
        return torch.tensor(rng.normal(0, np.sqrt(2 / (o * 9)), (o, i, 3, 3)),
                            dtype=torch.float32, device=dev)

    def bn(o):
        g, be = rng.normal(1, 0.1, o), rng.normal(0, 0.1, o)
        m, v = rng.normal(0, 0.1, o), rng.uniform(0.5, 1.5, o)
        s = g / np.sqrt(v + 1e-5)
        return (torch.tensor(s, dtype=torch.float32, device=dev),
                torch.tensor(be - m * s, dtype=torch.float32, device=dev))

    x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                     device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    return (x, conv(64, 3), *bn(64), conv(64, 64), *bn(64), relu2)


def logits(rng, b, c, h, w, dt, dev):
    return torch.tensor(rng.normal(0, 1, (b, h, w, c)), device=dev).to(dt).permute(0, 3, 1, 2)


def measure_pair(stem, dev):
    fn, plain = stem.stem_s1_pair_fused, stem.stem_s1_pair_fused_plain
    warm = "packed" in inspect.signature(fn).parameters
    rng = np.random.default_rng(0)
    for i, shape in enumerate(((*FRAME, True),) + PAIR_RAGGED):
        args = pair_args(rng, *shape, dev)
        got = fn(*args)
        torch.cuda.synchronize()
        want = plain(*args)
        row = {"kernel": "stem_s1_pair_fused", "shape": list(shape), "rel": rel(got, want),
               "bit_equal": bit_equal(got, want),
               "bit_equal_f64": bit_equal(got, exact_plain(stem, plain, args)),
               "plain_bit_equal_f64": bit_equal(want, exact_plain(stem, plain, args)),
               "finite": bool(torch.isfinite(got.float()).all())}
        if i == 0:
            kw = {"packed": stem.pack_s1_pair(*args[1:7])} if warm else {}
            if warm:
                row["warm_equals_cold"] = torch.equal(fn(*args, **kw), got)
            row["cold_ms"] = cuda_ms(lambda: fn(*args))
            row["ms"] = cuda_ms(lambda: fn(*args, **kw)) if warm else row["cold_ms"]
            row["device_ms"] = device_ms(lambda: fn(*args, **kw), "pair_kernel")
            row["plain_ms"] = cuda_ms(lambda: plain(*args), n=5)
            b, _, h, w = args[0].shape
            flops = 2 * b * (h // 2) * (w // 2) * 64 * (27 + 576)
            byts = sum(t.numel() * t.element_size() for t in args
                       if torch.is_tensor(t)) + got.numel() * 2
            row["bound_ms"] = max(flops / BF16_FLOP_PER_S, byts / HBM_BYTES_PER_S) * 1e3
        print(json.dumps(row), flush=True)


def measure_upsample(ua, dev):
    rng = np.random.default_rng(1)
    for i, (b, c, h, w, s, dt) in enumerate((LOGITS,) + UA_RAGGED):
        lg = logits(rng, b, c, h, w, dt, dev)
        got = ua.upsample_argmax(lg, s)
        torch.cuda.synchronize()
        want = ua.upsample_argmax_plain(lg, s)
        row = {"kernel": "upsample_argmax", "shape": [b, c, h, w], "scale": s,
               "dtype": str(dt), "differing_pixels": int((got != want).sum()),
               "same_shape": got.shape == want.shape}
        if i == 0:
            row["ms"] = cuda_ms(lambda: ua.upsample_argmax(lg, s))
            row["device_ms"] = device_ms(lambda: ua.upsample_argmax(lg, s),
                                         "upsample_argmax_kernel")
            row["plain_ms"] = cuda_ms(lambda: ua.upsample_argmax_plain(lg, s), n=5)
            # as chip_smoke.py counts them: 3 f32 operations a vertical and a
            # horizontal value, a comparison a class after the first
            flops = 3 * b * c * h * s * (w + w * s) + b * h * s * w * s * (c - 1)
            byts = lg.numel() * lg.element_size() + got.numel() * 4
            row["bound_ms"] = max(flops / F32_FLOP_PER_S, byts / HBM_BYTES_PER_S) * 1e3
        print(json.dumps(row), flush=True)


# ------------------------------------------------------------- the split

# (file, anchor, replacement): a variant applies where its anchors are found
PAIR_VARIANTS = {
    "no_s1": [("stem.cu", "    hd_s1(win + (k & 1) * kStemWinBytes, tbl_s, s1 + hd_slot(r) * kPrRow,",
               "    if (H < 0) hd_s1(win + (k & 1) * kStemWinBytes, tbl_s, s1 + hd_slot(r) * kPrRow,")],
    "no_s12_mma": [("stem.cu", "        wgmma_m64n64k16(acc[dx & 1], a[dx][ks],\n"
                    "                        sw128_desc(w_s + tap * kHdSlice + 32 * ks));",
                    "        if (r < -8) wgmma_m64n64k16(acc[dx & 1], a[dx][ks],\n"
                    "                        sw128_desc(w_s + tap * kHdSlice + 32 * ks));")],
    "no_store": [("stem.cu", "        bulk_s2g(out + (((size_t)g.b * H2 + r) * W2 + g.p0) * 64, st,",
                  "        if (H < 0) bulk_s2g(out + (((size_t)g.b * H2 + r) * W2 + g.p0) * 64, st,")],
    "no_window": [("stem.cu", "    if (fvalid && fr >= 0 && fr < H2)\n"
                   "      stem_window_async(buf, xb, total, StemTile{fg.b, fr, fg.p0 - 1},",
                   "    if (H < 0)\n"
                   "      stem_window_async(buf, xb, total, StemTile{fg.b, fr, fg.p0 - 1},")],
}
UA_VARIANTS = {
    "no_store": [("upsample_argmax.cu", "      if (py >= s || y < 0 || y >= H) continue;",
                  "      if (py >= s || y < 0 || y >= H || arg[r][0] + arg[r][KP - 1] != -7) continue;")],
    "no_argmax": [("upsample_argmax.cu",
                   "      if (kFirst || v > best[r][p]) {  // strict: the earliest class wins a tie\n"
                   "        best[r][p] = v;\n        arg[r][p] = c;\n      }",
                   "      best[r][p] = kFirst ? v : __fadd_rn(best[r][p], v);\n"
                   "      arg[r][p] = __float_as_int(best[r][p]);")],
    "no_stage": [("upsample_argmax.cu", "  if (nchunk == 1)\n    ua_stage(",
                  "  if (H < 0)\n    ua_stage(")],
    "lerp_3op": [("upsample_argmax.cu", "  return __fmaf_rn(wlo, a, __fmul_rn(whi, b));",
                  "  return __fadd_rn(__fmul_rn(wlo, a), __fmul_rn(whi, b));")],
    "no_table": [("upsample_argmax.cu",
                  "    tbl[i] = interp_weights<T>(min(max(s * j + o + p, 0), n * s - 1), n, n * s);",
                  "    tbl[i] = make_float2(0.5f, 0.5f);")],
    "four_per_sm": [("upsample_argmax.cu", "constexpr int kUaBlocksPerSm = 6;",
                     "constexpr int kUaBlocksPerSm = 4;")],
    "eight_per_sm_rows1": [("upsample_argmax.cu", "constexpr int kUaBlocksPerSm = 6;",
                            "constexpr int kUaBlocksPerSm = 8;"),
                           ("upsample_argmax.cu", "constexpr int kUaRows = 2;",
                            "constexpr int kUaRows = 1;")],
    "rows1": [("upsample_argmax.cu", "constexpr int kUaRows = 2;", "constexpr int kUaRows = 1;")],
}


def split(tree, stem, dev):
    if not hasattr(stem, "pack_s1_pair"):
        return  # a tree before this design: its launcher takes other weights
    out_dir = tree / "mds_tpu_torch" / "build" / "pp_bench"
    jobs = {"pair": build_variants("stem.cu", {"built": [], **PAIR_VARIANTS}, out_dir / "pair"),
            "upsample_argmax": build_variants("upsample_argmax.cu",
                                              {"built": [], **UA_VARIANTS}, out_dir / "ua")}
    P, I = ctypes.c_void_p, ctypes.c_int
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    pa = pair_args(np.random.default_rng(0), *FRAME, True, dev)
    t1, w2p, b2 = stem.pack_s1_pair(*pa[1:7])
    b, _, h, w = pa[0].shape
    p_out = torch.empty((b, 64, h // 2, w // 2), dtype=torch.bfloat16, device=dev,
                        memory_format=torch.channels_last)
    lb, lc, lh, lw, ls, ldt = LOGITS
    lg = logits(np.random.default_rng(1), lb, lc, lh, lw, ldt, dev)
    u_out = torch.empty((lb, lh * ls, lw * ls), dtype=torch.int32, device=dev)
    for kernel, procs in jobs.items():
        key = "pair_kernel" if kernel == "pair" else "upsample_argmax_kernel"
        times = {}
        for name, p in procs.items():
            log = built(f"{kernel} {name}", p)
            if name == "built":
                print(json.dumps({"ptxas": kernel, "lines": ptxas_lines(log, key)}), flush=True)
            lib = ctypes.CDLL(str(out_dir / ("pair" if kernel == "pair" else "ua") / name
                                  / "lib.so"))
            if kernel == "pair":
                fn = lib.mds_stem_s1_pair_fused
                fn.argtypes = [P] * 5 + [I] * 4 + [P]
                call_args = lambda: (ptr(pa[0]), ptr(t1), ptr(w2p), ptr(b2), ptr(p_out),  # noqa: E731
                                     b, h, w, 1, stream())
            else:
                fn = lib.mds_upsample_argmax
                fn.argtypes = [P] * 2 + [I] * 6 + [P]
                call_args = lambda: (ptr(lg), ptr(u_out), lb, lh, lw, lc, ls,  # noqa: E731
                                     int(ldt == torch.float32), stream())

            def call():
                err = fn(*call_args())
                if err:
                    raise RuntimeError(f"{kernel} {name}: launch failed ({err})")

            times[name] = device_ms(call, key)
        print(json.dumps({"split": kernel, "device_ms": times}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="time another checkout's mds_tpu_torch")
    ap.add_argument("--no-split", action="store_true", help="skip the split")
    args = ap.parse_args()
    tree = open_tree(args.tree, "pred_pair_bench_torch")
    from mds_tpu_torch.ops import stem
    from mds_tpu_torch.ops import upsample_argmax as ua

    dev = "cuda"
    measure_pair(stem, dev)
    measure_upsample(ua, dev)
    if not args.no_split:
        split(tree, stem, dev)
    print_card()


if __name__ == "__main__":
    main()
