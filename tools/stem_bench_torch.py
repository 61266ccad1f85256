#!/usr/bin/env python
"""Kernels 1 and 2 (csrc/stem.cu: the 3×3 s2 RGB stem, its window variant
and its f32 training form) on a CUDA card, at the main paths' shapes.

  python tools/stem_bench_torch.py [--tree DIR] [--no-split]

At the stem route's inputs (1, 3, 1024, 2048) → 64 and → 16 (folded BN,
ReLU, bf16 out) and the train step's (16, 3, 512, 1024) → 64 and → 16 (bf16
weight, f32 out), plus ragged shapes, each kernel against its plain version
(rel max-diff, bit-equal share; kernel 2 bit for bit against kernel 1) and
timed: the warm wrapper on a packed table and the cold one packing in the
call (median of 20 CUDA-event runs), the kernel's device time (torch.profiler,
mean of 10), the plain version, the library's one call (bf16 F.conv2d with
the folded weight and bias; for the train form also f32 F.conv2d, TF32 off)
and the bound (bytes over 3.35 TB/s). One JSON line per shape.

Then the split: stem.cu built again with one part taken out at a time
("no_window": no window copies; "no_mma": no wgmma, the accumulators stay
zero; "no_store": no global stores), each variant's device time at the two
O = 64 shapes, into the git-ignored mds_tpu_torch/build/stem_bench/. What a
part costs is the built kernel's time less its variant's (the parts
overlap, so the differences need not add up).

--tree DIR times another checkout's wrappers instead (its mds_tpu_torch, built
there; before the hi/mid/lo table its wrappers take no `packed` and its
training form writes bf16), for a comparison within one call; the split is
then skipped. The card's name, power limit and SM clock close the output.
"""

import argparse
import ctypes
import inspect
import json

import numpy as np
import torch
import torch.nn.functional as F

from bench_util_torch import (HBM_BYTES_PER_S, ROOT, bits, build_variants, built, cuda_ms,
                              device_ms, open_tree, print_card, ptxas_lines, rel)

EVAL = (1, 1024, 2048)
TRAIN = (16, 512, 1024)
RAGGED = ((2, 18, 134), (1, 6, 2050), (3, 2, 2))


def inputs(rng, b, h, w, o, dev):
    x = torch.tensor(rng.normal(0, 1, (b, h, w, 3)), dtype=torch.float32,
                     device=dev).to(torch.bfloat16).permute(0, 3, 1, 2)
    k = torch.tensor(rng.normal(0, np.sqrt(2 / (o * 9)), (o, 3, 3, 3)),
                     dtype=torch.float32, device=dev)
    g, be = rng.normal(1, 0.1, o), rng.normal(0, 0.1, o)
    m, v = rng.normal(0, 0.1, o), rng.uniform(0.5, 1.5, o)
    s = g / np.sqrt(v + 1e-5)
    return (x, k, torch.tensor(s, dtype=torch.float32, device=dev),
            torch.tensor(be - m * s, dtype=torch.float32, device=dev))


def measure(stem, dev):
    """Every kernel of the tree's ops.stem at each shape: one JSON line each."""
    new = "packed" in inspect.signature(stem.stem_conv_bn_relu_s2).parameters
    rng = np.random.default_rng(0)
    rows = []
    for (b, h, w), o, form in [(EVAL, 64, "eval"), (EVAL, 16, "eval"), (TRAIN, 64, "train"),
                               (TRAIN, 16, "train")] + [(s, o, f) for s in RAGGED
                                                         for o, f in ((64, "eval"), (24, "train"))]:
        ragged = (b, h, w) in RAGGED
        x, k, s, bias = inputs(rng, b, h, w, o, dev)
        row = {"form": form, "x": [b, 3, h, w], "O": o}
        if form == "eval":
            packed = stem.pack_stem(k, s, bias) if new else None
            kw = {"packed": packed} if new else {}
            args = (x, k, s, bias, True)
            want = stem.stem_conv_bn_relu_s2_plain(*args)
            fns = {"stem_conv_bn_relu_s2": stem.stem_conv_bn_relu_s2,
                   "stem_conv_bn_relu_s2_window": stem.stem_conv_bn_relu_s2_window}
            first = None
            for name, fn in fns.items():
                got = fn(*args, **kw)
                torch.cuda.synchronize()
                r = {"rel": rel(got, want), "dtype": str(got.dtype),
                     "bit_equal": (bits(got) == bits(want)).float().mean().item()}
                if first is None:
                    first = got
                else:
                    r["equal_to_stem_conv_bn_relu_s2"] = torch.equal(bits(got), bits(first))
                if not ragged:
                    r["ms"] = cuda_ms(lambda: fn(*args, **kw))
                    r["cold_ms"] = cuda_ms(lambda: fn(*args))
                    r["device_ms"] = device_ms(lambda: fn(*args, **kw), "stem")
                row[name] = r
            if not ragged:
                wf = (k * s.reshape(-1, 1, 1, 1)).to(torch.bfloat16)
                bf = bias.to(torch.bfloat16)
                row["library_bf16_ms"] = cuda_ms(lambda: F.conv2d(x, wf, bf, stride=2, padding=1))
                row["plain_ms"] = cuda_ms(lambda: stem.stem_conv_bn_relu_s2_plain(*args))
        else:
            kb = k.to(torch.bfloat16)
            packed = stem.pack_stem(kb) if new else None
            kw = (packed,) if new else ()
            fn = stem.stem_conv3x3_s2
            got = fn(x, kb, *kw)
            torch.cuda.synchronize()
            want = stem.stem_conv3x3_s2_plain(x, kb)
            exact = F.conv2d(x.double(), kb.double(), stride=2, padding=1)
            r = {"rel": rel(got, want), "rel_vs_f64": rel(got, exact), "dtype": str(got.dtype)}
            if not ragged:
                r["ms"] = cuda_ms(lambda: fn(x, kb, *kw))
                r["cold_ms"] = cuda_ms(lambda: fn(x, kb))
                r["device_ms"] = device_ms(lambda: fn(x, kb, *kw), "stem")
                xf, kf = x.float(), kb.float()
                row["library_f32_ms"] = cuda_ms(lambda: F.conv2d(xf, kf, stride=2, padding=1))
                row["library_bf16_ms"] = cuda_ms(lambda: F.conv2d(x, kb, stride=2, padding=1))
                row["plain_ms"] = cuda_ms(lambda: stem.stem_conv3x3_s2_plain(x, kb), n=5)
            row["stem_conv3x3_s2"] = r
        out_bytes = b * o * (h // 2) * (w // 2) * (4 if form == "train" and new else 2)
        row["bound_ms"] = (x.numel() * 2 + out_bytes) / HBM_BYTES_PER_S * 1e3
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


# ------------------------------------------------------------- the split

# (file, anchor, replacement), as bench_util_torch.build_variants takes them
VARIANTS = {
    "built": [],
    "no_window": [
        ("stem.cu", "    if (g + 16 > lo && g < hi)\n      cp_async16(win + dy * kStemRowBytes",
         "    if (H < 0)\n      cp_async16(win + dy * kStemRowBytes"),
        ("stem.cu", "  mbar_arrive_expect_tx(bar, bytes);\n  for (int dy = 0; dy < 3; ++dy)",
         "  mbar_arrive_expect_tx(bar, 0);\n  for (int dy = 0; dy < 3 * (H < 0); ++dy)")],
    "no_mma": [("stem.cu", "  for (int step = 0; step < 6; ++step)  // hi: steps 0, 1; mid: 2, 3;"
                " lo: 4, 5\n    wgmma_m64nk16<N>(",
                "  for (int step = 0; step < 6 * (H < 0); ++step)\n    wgmma_m64nk16<N>(")],
    "no_store": [("stem.cu", "    stem_tile_store<F32>(", "    if (H < 0) stem_tile_store<F32>(")],
}


def split(dev):
    from mds_tpu_torch.ops import stem

    out_dir = ROOT / "mds_tpu_torch" / "build" / "stem_bench"
    procs = build_variants("stem.cu", VARIANTS, out_dir)
    P, I = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for name, p in procs.items():
        log = built(name, p)
        if name == "built":  # ptxas: registers, spills, wgmma serialization
            print(json.dumps({"ptxas": ptxas_lines(log)}), flush=True)
        lib = ctypes.CDLL(str(out_dir / name / "lib.so"))
        lib.mds_stem_conv_bn_relu_s2.argtypes = [P, P, P, I, I, I, I, I, I, P]
        lib.mds_stem_conv_bn_relu_s2_window.argtypes = [P, P, P, I, I, I, I, I, P]
        libs[name] = lib
    if set(libs) != set(VARIANTS):
        raise RuntimeError(f"stem.cu lacks the anchors of {set(VARIANTS) - set(libs)}")
    rng = np.random.default_rng(1)
    ptr = lambda t: ctypes.c_void_p(t.data_ptr())  # noqa: E731
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)  # noqa: E731
    res = {}
    for (b, h, w), form in ((EVAL, "eval"), (TRAIN, "train")):
        x, k, s, bias = inputs(rng, b, h, w, 64, dev)
        f32 = form == "train"
        table = stem.pack_stem(k.to(torch.bfloat16)) if f32 else stem.pack_stem(k, s, bias)
        out = torch.empty((b, 64, h // 2, w // 2), device=dev, memory_format=torch.channels_last,
                          dtype=torch.float32 if f32 else torch.bfloat16)
        calls = {"kernel1": lambda lib: lib.mds_stem_conv_bn_relu_s2(
            ptr(x), ptr(table), ptr(out), b, h, w, 64, int(not f32), int(f32), stream())}
        if not f32:
            calls["kernel2"] = lambda lib: lib.mds_stem_conv_bn_relu_s2_window(
                ptr(x), ptr(table), ptr(out), b, h, w, 64, 1, stream())
        for kname, call in calls.items():
            times = {}
            for name, lib in libs.items():
                if call(lib):
                    raise RuntimeError(f"{name} {kname}: launch failed")
                times[name] = device_ms(lambda: call(lib), "stem")
            res[f"{form}_{kname}"] = times
            print(json.dumps({"split": f"{form} {kname}", "x": [b, 3, h, w], "O": 64,
                              "device_ms": times}), flush=True)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", help="time another checkout's mds_tpu_torch")
    ap.add_argument("--no-split", action="store_true", help="skip the split")
    args = ap.parse_args()
    open_tree(args.tree, "stem_bench_torch")
    from mds_tpu_torch.ops import stem

    measure(stem, "cuda")
    if not args.tree and not args.no_split:
        split("cuda")
    print_card()


if __name__ == "__main__":
    main()
