#!/usr/bin/env python
"""Kernels 4 (csrc/stem.cu: the DetailBranch head, S1_1 → S1_2 → S2_1), 9
(csrc/depthwise.cu: the depthwise / channel-multiplier 3×3) and 10 (its
stride-1 form with a staged window) on a CUDA card, at the served frame's
shapes.

  python tools/head_dw_bench_torch.py [--tree DIR] [--no-split]

Kernel 4 at (1, 3, 1024, 2048) and at ragged shapes against its plain
version (rel max-diff, bit-equal share), timed warm on its packed weights
(where the tree packs once), cold (packing in the call), both as the median
of 20 CUDA-event runs, and by its device time (torch.profiler, mean of 10).
Kernel 9 at the 16 shapes of a 1024×2048 BiSeNetV2 frame: bit-equal share,
its device time per call and that of bf16 F.conv2d(groups=C), the library's
one call for the same function, and the bound (bytes over 3.35 TB/s). One
JSON line per shape. Kernel 10 at the frame's 10 stride-1 shapes: bit-equal
to the plain version and to kernel 9, its wrapper ms (median of 20 CUDA-event
runs) and device ms beside kernel 9's device ms, the library call's and the
bound; one line per shape and one for their sums.

Then the split: the tree's csrc built again with one part of kernel 4 taken
out at a time (this design: "no_s1_window", "no_s1_mma", "no_s12_mma",
"no_s21_mma", "no_store", "no_ring_wait", "noinline", "s21_no_ring",
"s21_stride1", "one_chain"; the design before it,
whose weights stream from L2 for every warp pass: "no_weight_loads", B
fragments made in registers), each variant's device time at the frame
shape, into the git-ignored mds_tpu_torch/build/head_bench/ of the tree;
depthwise.cu variants of kernel 9's staged tile; and depthwise.cu variants
of kernel 10 (WIN_VARIANTS: without the window copies, the ring at one and
two stages, without the stores, the old kernel's 8-channel 16-column
tile, 2 or 8 pixels a thread at m = 1, 4 at m > 1, nine warps a block, two
blocks an SM at m > 1) at its 10 shapes, after ptxas's registers and spills
of every dw3x3_window_kernel entry.
What a part costs is the built kernel's time less its variant's (the parts
overlap; the differences need not add up, and a variant's numbers are wrong
by design). A variant with a wgmma under a condition serializes every wgmma
of the kernel (ptxas C7520), which inflates it. The "stages" build also
prints thread 0's cycles per block and call from each of the block's
barriers back to the one before, by the source line of the barrier.

--tree DIR times another checkout's wrappers (its mds_tpu_torch, built
there), for a comparison within one call. The card's name, power limit and
SM clock close the output.
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
HEAD_RAGGED = ((2, 36, 260), (1, 4, 4), (1, 20, 252), (3, 12, 136))
# the depthwise convs of one 1024×2048 BiSeNetV2 frame: (C, H, W, m, stride)
# of each input, in the order the model runs them (GE layers of S3, S4, S5,
# then the BGA layer's two)
DW_FRAME = ((16, 256, 512, 6, 2), (96, 128, 256, 1, 1), (16, 256, 512, 1, 2),
            (32, 128, 256, 6, 1),
            (32, 128, 256, 6, 2), (192, 64, 128, 1, 1), (32, 128, 256, 1, 2),
            (64, 64, 128, 6, 1),
            (64, 64, 128, 6, 2), (384, 32, 64, 1, 1), (64, 64, 128, 1, 2),
            (128, 32, 64, 6, 1), (128, 32, 64, 6, 1), (128, 32, 64, 6, 1),
            (128, 128, 256, 1, 1), (128, 32, 64, 1, 1))


def head_args(rng, b, h, w, dev):
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
    return (x, conv(64, 3), *bn(64), conv(64, 64), *bn(64), conv(64, 64), *bn(64))


def head_packed(stem, args):
    """The tree's kernel-4 weights as its launcher reads them."""
    return stem.pack_detail_head(*args[1:])


def measure_head(stem, dev):
    warm = "packed" in inspect.signature(stem.detail_s1s2_fused).parameters
    rng = np.random.default_rng(0)
    for b, h, w in (FRAME,) + HEAD_RAGGED:
        args = head_args(rng, b, h, w, dev)
        fn = stem.detail_s1s2_fused
        got = fn(*args)
        torch.cuda.synchronize()
        want = stem.detail_s1s2_fused_plain(*args)
        row = {"kernel": "detail_s1s2_fused", "x": [b, 3, h, w], "rel": rel(got, want),
               "bit_equal": bit_equal(got, want),
               "bit_equal_f64": bit_equal(got, exact_plain(stem, stem.detail_s1s2_fused_plain, args)),
               "plain_bit_equal_f64": bit_equal(want, exact_plain(stem, stem.detail_s1s2_fused_plain, args)),
               "finite": bool(torch.isfinite(got.float()).all())}
        if (b, h, w) == FRAME:
            packed = head_packed(stem, args) if warm else None
            kw = {"packed": packed} if warm else {}
            row["cold_ms"] = cuda_ms(lambda: fn(*args))
            row["ms"] = cuda_ms(lambda: fn(*args, **kw)) if warm else row["cold_ms"]
            row["device_ms"] = device_ms(lambda: fn(*args, **kw), "detail_")
            p4 = b * (h // 4) * (w // 4)
            flops = 2 * 4 * p4 * 64 * (27 + 576) + 2 * p4 * 64 * 576
            byts = sum(t.numel() * t.element_size() for t in args) + got.numel() * 2
            row["bound_ms"] = max(flops / BF16_FLOP_PER_S, byts / HBM_BYTES_PER_S) * 1e3
        print(json.dumps(row), flush=True)


def measure_depthwise(depthwise, dev):
    rng = np.random.default_rng(1)
    dev_total = lib_total = bound_total = 0.0
    rows = []
    for c, h, w, m, s in DW_FRAME:
        x = torch.tensor(rng.normal(0, 1, (1, h, w, c)), dtype=torch.float32,
                         device=dev).relu().to(torch.bfloat16).permute(0, 3, 1, 2)
        wt = torch.tensor(rng.normal(0, 0.3, (c * m, 1, 3, 3)), dtype=torch.float32,
                          device=dev).to(torch.bfloat16)
        with torch.no_grad():
            got = depthwise.depthwise3x3(x, wt, s)
            want = depthwise.depthwise3x3_plain(x, wt, s)
            row = {"kernel": "depthwise3x3", "x": [1, c, h, w], "m": m, "stride": s,
                   "bit_equal": bit_equal(got, want),
                   "ms": cuda_ms(lambda: depthwise.depthwise3x3(x, wt, s)),
                   "device_ms": device_ms(lambda: depthwise.depthwise3x3(x, wt, s)),
                   "library_device_ms": device_ms(
                       lambda: F.conv2d(x, wt, None, s, 1, 1, c)),
                   "bound_ms": (x.numel() + wt.numel() + got.numel()) * 2
                   / HBM_BYTES_PER_S * 1e3}
        dev_total += row["device_ms"] if isinstance(row["device_ms"], float) else float("nan")
        lib_total += row["library_device_ms"] if isinstance(row["library_device_ms"], float) \
            else float("nan")
        bound_total += row["bound_ms"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps({"kernel": "depthwise3x3", "frame_device_ms": dev_total,
                      "frame_library_device_ms": lib_total, "frame_bound_ms": bound_total,
                      "min_bit_equal": min(r["bit_equal"] for r in rows)}), flush=True)


def window_shapes(dev):
    """Kernel 10's inputs: the frame's stride-1 depthwise convs, (x, w, m)."""
    rng = np.random.default_rng(2)
    out = []
    for c, h, w, m, s in DW_FRAME:
        if s != 1:
            continue
        x = torch.tensor(rng.normal(0, 1, (1, h, w, c)), dtype=torch.float32,
                         device=dev).relu().to(torch.bfloat16).permute(0, 3, 1, 2)
        wt = torch.tensor(rng.normal(0, 0.3, (c * m, 1, 3, 3)), dtype=torch.float32,
                          device=dev).to(torch.bfloat16)
        out.append((x, wt, m))
    return out


def measure_window(depthwise, dev):
    """Kernel 10 at window_shapes: one JSON line per shape, one of sums."""
    keys = ("ms", "device_ms", "k9_device_ms", "library_device_ms", "bound_ms")
    tot = dict.fromkeys(keys, 0.0)
    eq = []
    for x, wt, m in window_shapes(dev):
        c = x.shape[1]
        with torch.no_grad():
            got = depthwise.depthwise3x3_dma(x, wt)
            torch.cuda.synchronize()
            want = depthwise.depthwise3x3_plain(x, wt, 1)
            k9 = depthwise.depthwise3x3(x, wt, 1)
            row = {"kernel": "depthwise3x3_dma", "x": list(x.shape), "m": m,
                   "bit_equal": bit_equal(got, want), "equal_to_k9": bit_equal(got, k9),
                   "ms": cuda_ms(lambda: depthwise.depthwise3x3_dma(x, wt)),
                   "device_ms": device_ms(lambda: depthwise.depthwise3x3_dma(x, wt),
                                          "dw3x3_window"),
                   "k9_device_ms": device_ms(lambda: depthwise.depthwise3x3(x, wt, 1),
                                             "dw3x3_kernel"),
                   "library_device_ms": device_ms(lambda: F.conv2d(x, wt, None, 1, 1, 1, c)),
                   "bound_ms": (x.numel() + wt.numel() + got.numel()) * 2
                   / HBM_BYTES_PER_S * 1e3}
        for k in keys:
            tot[k] += row[k] if isinstance(row[k], float) else float("nan")
        eq += [row["bit_equal"], row["equal_to_k9"]]
        print(json.dumps(row), flush=True)
    print(json.dumps({"kernel": "depthwise3x3_dma", "shapes": 10,
                      **{f"sum_{k}": v for k, v in tot.items()}, "min_bit_equal": min(eq)}),
          flush=True)


# ------------------------------------------------------------- the split

# (file, anchor, replacement): a variant applies where its anchor is found
VARIANTS = {
    "no_s1_window": [("stem.cu", "    if (fvalid && fr >= 0 && fr < H2)\n",
                      "    if (H < 0)\n")],
    "no_s1_mma": [("stem.cu", "  for (int step = 0; step < 6; ++step)  // hi: steps 0, 1; mid: 2, 3;"
                   " lo: 4, 5\n    wgmma_m64nk16<N>(",
                   "  for (int step = 0; step < 6 * (H < 0); ++step)\n    wgmma_m64nk16<N>(")],
    "no_s12_mma": [("stem.cu", "        wgmma_m64n64k16(acc[dx & 1], a[dx][ks],",
                    "        if (H2 < 0) wgmma_m64n64k16(acc[dx & 1], a[dx][ks],")],
    "no_s21_mma": [("stem.cu", "        wgmma_m64n32k16(acc[dx & 1], a[dx][ks],",
                    "        if (H4 < 0) wgmma_m64n32k16(acc[dx & 1], a[dx][ks],")],
    "no_store": [("stem.cu", "      *reinterpret_cast<uint32_t*>(o + c) = pack2(v0, v1);",
                  "      if (H4 < 0) *reinterpret_cast<uint32_t*>(o + c) = pack2(v0, v1);")],
    "no_ring_wait": [("stem.cu", "    mbar_wait(ring.full + slot, (sl / kHdSlots) & 1);",
                      "    if (H4 < 0) mbar_wait(ring.full + slot, (sl / kHdSlots) & 1);")],
    "s21_no_ring": [("stem.cu", "      mbar_wait(ring.full + slot, (sl / kHdSlots) & 1);\n", ""),
                    ("stem.cu", "      if (tap > 0) ring.release(sl - 1);  // take tap + 2\n", ""),
                    ("stem.cu", "  wgmma_wait<0>();\n  ring.release(n + 8);\n",
                     "  wgmma_wait<0>();\n")],
    "s21_stride1": [("stem.cu", "  const int pix = 2 * min(hd_arow(), kHdW - 1);",
                     "  const int pix = min(hd_arow(), kHdW - 1);")],
    "one_chain": [("stem.cu", "acc[dx & 1]", "acc[0]")],
    # thread 0's clock64 between the block's barriers, summed per source line
    "stages": [("stem.cu", "__global__ void __launch_bounds__(kHdThreads, 1)\n    detail_head_kernel(",
                "__device__ unsigned long long g_hd_cyc[64];\n"
                "__global__ void __launch_bounds__(kHdThreads, 1)\n    detail_head_kernel("),
               ("stem.cu", "  uint32_t n = 0;  // S2_1 slices consumed\n",
                "  uint32_t n = 0;  // S2_1 slices consumed\n"
                "  unsigned long long hd_t = clock64();\n"),
               ("stem.cu", "      if (q > g.qa) hd_s21(s2_s, wring, n, b3, out, g, q - 1, H4, W4);\n",
                "      if (q > g.qa) hd_s21(s2_s, wring, n, b3, out, g, q - 1, H4, W4);\n"
                "      if (threadIdx.x == 0) { const unsigned long long t_ = clock64(); "
                "atomicAdd(&g_hd_cyc[__LINE__ & 63], t_ - hd_t); hd_t = t_; }\n"),
               ("stem.cu", "    named_bar_sync(1, kHdThreads);",
                "    { named_bar_sync(1, kHdThreads); if (threadIdx.x == 0) { "
                "const unsigned long long t_ = clock64(); "
                "atomicAdd(&g_hd_cyc[__LINE__ & 63], t_ - hd_t); hd_t = t_; } }"),
               ("stem.cu", 'extern "C" int mds_stemblock_fused(',
                'extern "C" int mds_hd_cycles(unsigned long long* h, int reset) {\n'
                "  unsigned long long z[64] = {};\n"
                "  return (int)(reset ? cudaMemcpyToSymbol(g_hd_cyc, z, sizeof(z))\n"
                "                     : cudaMemcpyFromSymbol(h, g_hd_cyc, sizeof(z)));\n}\n\n"
                'extern "C" int mds_stemblock_fused(')],
    "noinline": [("stem.cu", "__device__ __forceinline__ void hd_s12(",
                  "__device__ __noinline__ void hd_s12("),
                 ("stem.cu", "__device__ __forceinline__ void hd_s21(",
                  "__device__ __noinline__ void hd_s21(")],
    "no_weight_loads": [("mma.cuh", "        const uint2 bv = __ldg(wk + nt * 32);",
                         "        const uint2 bv = make_uint2(0x3F80u * lane, nt);")],
}


def split(tree, stem, dev):
    def skip(name, srcs):  # the earlier design (detail_kernel): no_weight_loads only
        return name != "built" and ("detail_kernel(" in srcs["stem.cu"]) != (
            name == "no_weight_loads")

    out_dir = tree / "mds_tpu_torch" / "build" / "head_bench"
    procs = build_variants("stem.cu", {"built": [], **VARIANTS}, out_dir, skip)
    P, I = ctypes.c_void_p, ctypes.c_int
    args = head_args(np.random.default_rng(0), *FRAME, dev)  # measure_head's
    packed = head_packed(stem, args)
    x = args[0]
    b, _, h, w = x.shape
    out = torch.empty((b, 64, h // 4, w // 4), dtype=torch.bfloat16, device=dev,
                      memory_format=torch.channels_last)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    times = {}
    for name, p in procs.items():
        log = built(name, p)
        if name == "built":  # ptxas: registers, spills, wgmma serialization
            print(json.dumps({"ptxas": ptxas_lines(log)}), flush=True)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        fn = lib.mds_detail_s1s2_fused
        fn.argtypes = [P] * 7 + [I, I, I, P]

        def call():
            err = fn(ptr(x), *map(ptr, packed), ptr(out), b, h, w,
                     ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")

        times[name] = device_ms(call, "detail_")
        if name == "stages":  # cycles per block and call, by barrier line
            buf = (ctypes.c_ulonglong * 64)()
            lib.mds_hd_cycles(buf, 1)
            for _ in range(10):
                call()
            torch.cuda.synchronize()
            lib.mds_hd_cycles(buf, 0)
            lines = (out_dir / name / "stem.cu").read_text().splitlines()
            strips = -(-(w // 4) // 62)
            steps = strips * (h // 4) * b
            sms = torch.cuda.get_device_properties(0).multi_processor_count
            per = -(-steps // sms)
            blocks = -(-steps // per)
            print(json.dumps({"stages": {
                f"{i + 1}": [buf[(i + 1) & 63] / blocks / 10,
                              " | ".join(t.strip() for t in lines[i - 3:i])[-120:]]
                for i, ln in enumerate(lines) if "g_hd_cyc[__LINE__" in ln},
                "blocks": blocks, "steps_per_block": per}), flush=True)
    print(json.dumps({"split": "detail_s1s2_fused", "x": [b, 3, h, w],
                      "device_ms": times}), flush=True)


# variants of the staged multiplier kernel (csrc/depthwise.cu), m <= 6
DW_VARIANTS = {
    "built": [],
    "rows8": [("depthwise.cu", "constexpr int kMTH = 4, kMTW = 32, kMP = 4;",
               "constexpr int kMTH = 8, kMTW = 32, kMP = 4;"),
              ("depthwise.cu", "constexpr int kMMax = 12;", "constexpr int kMMax = 6;")],
    "px2": [("depthwise.cu", "constexpr int kMTH = 4, kMTW = 32, kMP = 4;",
             "constexpr int kMTH = 4, kMTW = 32, kMP = 2;"),
            ("depthwise.cu", "constexpr int kMMax = 12;", "constexpr int kMMax = 6;")],
    "cols16": [("depthwise.cu", "constexpr int kMTH = 4, kMTW = 32, kMP = 4;",
                "constexpr int kMTH = 8, kMTW = 16, kMP = 4;")],
}


def split_depthwise(tree, dev):
    """Each DW_VARIANTS build of depthwise.cu at the frame's 16 shapes: the
    device ms per shape and over the frame (bit-equal to the plain version
    checked for every variant)."""
    from mds_tpu_torch.ops import depthwise

    out_dir = tree / "mds_tpu_torch" / "build" / "dw_bench"
    procs = build_variants("depthwise.cu", DW_VARIANTS, out_dir)
    rng = np.random.default_rng(1)
    shapes = []
    for c, h, w, m, s in DW_FRAME:
        x = torch.tensor(rng.normal(0, 1, (1, h, w, c)), dtype=torch.float32,
                         device=dev).relu().to(torch.bfloat16).permute(0, 3, 1, 2)
        wt = torch.tensor(rng.normal(0, 0.3, (c * m, 1, 3, 3)), dtype=torch.float32,
                          device=dev).to(torch.bfloat16)
        out = torch.empty((1, c * m, -(-h // s), -(-w // s)), dtype=torch.bfloat16,
                          device=dev, memory_format=torch.channels_last)
        shapes.append((x, wt, out, c, h, w, m, s, depthwise.depthwise3x3_plain(x, wt, s)))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    P, I = ctypes.c_void_p, ctypes.c_int
    res = {}
    for name, p in procs.items():
        built(name, p)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        lib.mds_dw3x3.argtypes = [P, P, P] + [I] * 7 + [P]
        per = []
        for x, wt, out, c, h, w, m, s, want in shapes:
            def call():
                err = lib.mds_dw3x3(ptr(x), ptr(wt), ptr(out), 1, h, w, c, m, s, 0,
                                    ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            if not torch.equal(out.view(torch.int16), want.view(torch.int16)):
                raise RuntimeError(f"{name}: differs from the plain version at {c, h, w, m, s}")
            t = device_ms(call, "dw3x3")
            per.append(t if isinstance(t, float) else float("nan"))
        res[name] = {"frame_device_ms": sum(per), "m6_device_ms": sum(
            t for t, sh in zip(per, DW_FRAME) if sh[3] > 1), "shapes": per}
    print(json.dumps({"split": "depthwise3x3", "device_ms": res}), flush=True)


# variants of kernel 10's TMA form (csrc/depthwise.cu), each anchor unique to
# it; WIN_RIGHT: the variants that must stay bit-equal to the plain version
WIN_VARIANTS = {
    "built": [],
    "no_tma": [("depthwise.cu", "        mbar_arrive_expect_tx(full + slot, g.box_bytes);\n"
                "        tma_load_4d(ring + slot * g.stage_bytes, &xmap,",
                "        mbar_arrive(full + slot);\n"
                "        if (g.H < 0) tma_load_4d(ring + slot * g.stage_bytes, &xmap,")],
    "ring1": [("depthwise.cu", "constexpr int kWinStages = 3;", "constexpr int kWinStages = 1;")],
    "ring2": [("depthwise.cu", "constexpr int kWinStages = 3;", "constexpr int kWinStages = 2;")],
    # a sum of every output keeps all the arithmetic alive without the stores
    "no_store": [("depthwise.cu", "          if (ox0 + p >= g.W) break;\n",
                  "          float chk = 0.f;\n"
                  "          for (int q = 0; q < kOut; ++q) chk += acc[p][q];\n"
                  "          if (ox0 + p >= g.W || chk != -1e30f) break;\n")],
    "old_tile": [("depthwise.cu", "constexpr int kWinRunBytes1 = 128, kWinRunBytesM = 64;",
                  "constexpr int kWinRunBytes1 = 16, kWinRunBytesM = 16;"),
                 ("depthwise.cu", "constexpr int kWinTW = 32, kWinTHMax = 32;",
                  "constexpr int kWinTW = 16, kWinTHMax = 8;")],
    "p2_m1": [("depthwise.cu", "constexpr int kWinP1 = 4, kWinPM = 8;",
               "constexpr int kWinP1 = 2, kWinPM = 8;")],
    "p8_m1": [("depthwise.cu", "constexpr int kWinP1 = 4, kWinPM = 8;",
               "constexpr int kWinP1 = 8, kWinPM = 8;")],
    "p4_mult": [("depthwise.cu", "constexpr int kWinP1 = 4, kWinPM = 8;",
                 "constexpr int kWinP1 = 4, kWinPM = 4;")],
    # nine warps a block: 168 registers a thread at most
    "nc256": [("depthwise.cu", "constexpr int kWinNC = 224;", "constexpr int kWinNC = 256;")],
    # two blocks an SM at m > 1: 128 registers a thread at most
    "two_blocks_mult": [("depthwise.cu", "__launch_bounds__(kWinNC + 32, 1)",
                         "__launch_bounds__(kWinNC + 32, MC ? 2 : 1)")],
}
WIN_RIGHT = ("built", "ring1", "ring2", "old_tile", "p2_m1", "p8_m1", "p4_mult", "nc256",
             "two_blocks_mult")


def split_window(tree, dev):
    """Each WIN_VARIANTS build of depthwise.cu at kernel 10's 10 shapes:
    device ms per shape and summed, bit-equality for the WIN_RIGHT ones;
    first ptxas's lines for dw3x3_window_kernel."""
    from mds_tpu_torch.ops import depthwise

    out_dir = tree / "mds_tpu_torch" / "build" / "win_bench"
    procs = build_variants("depthwise.cu", WIN_VARIANTS, out_dir)
    shapes = []
    for x, wt, m in window_shapes(dev):
        b, c, h, w = x.shape
        out = torch.empty((b, c * m, h, w), dtype=torch.bfloat16, device=dev,
                          memory_format=torch.channels_last)
        shapes.append((x, wt, out, c, h, w, m, depthwise.depthwise3x3_plain(x, wt, 1)))
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    P, I = ctypes.c_void_p, ctypes.c_int
    res = {}
    for name, p in procs.items():
        log = built(name, p)
        if name in ("built", "p8_m1", "nc256"):
            print(json.dumps({"ptxas": name, "lines": ptxas_lines(log, "dw3x3_window_kernel")}),
                  flush=True)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        lib.mds_dw3x3_window.argtypes = [P, P, P] + [I] * 6 + [P]
        per, right = [], True
        for x, wt, out, c, h, w, m, want in shapes:
            def call():
                err = lib.mds_dw3x3_window(ptr(x), ptr(wt), ptr(out), 1, h, w, c, m, 0,
                                           ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
                if err:
                    raise RuntimeError(f"{name}: launch failed ({err})")
            call()
            torch.cuda.synchronize()
            right = right and torch.equal(out.view(torch.int16), want.view(torch.int16))
            t = device_ms(call, "dw3x3_window")
            per.append(t if isinstance(t, float) else float("nan"))
        res[name] = {"sum_device_ms": sum(per), "m6_device_ms": sum(
            t for t, sh in zip(per, shapes) if sh[6] > 1), "shapes": per, "bit_equal": right}
    print(json.dumps({"split": "depthwise3x3_dma", "device_ms": res}), flush=True)
    wrong = [k for k in WIN_RIGHT if k in res and not res[k]["bit_equal"]]
    if wrong:
        raise RuntimeError(f"kernel 10 differs from the plain version in {wrong}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="time another checkout's mds_tpu_torch")
    ap.add_argument("--no-split", action="store_true", help="skip the split")
    args = ap.parse_args()
    tree = open_tree(args.tree, "head_dw_bench_torch")
    from mds_tpu_torch.ops import depthwise, stem

    measure_head(stem, "cuda")
    measure_depthwise(depthwise, "cuda")
    measure_window(depthwise, "cuda")
    if not args.no_split:
        split_window(tree, "cuda")
        split(tree, stem, "cuda")
        split_depthwise(tree, "cuda")
    print_card()


if __name__ == "__main__":
    main()
