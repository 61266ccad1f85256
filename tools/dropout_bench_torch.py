#!/usr/bin/env python
"""Kernel 12 (the SegmentHead dropout, mds_tpu_torch/csrc/dropout.cu) on a
CUDA card, at the main head's shape of the bs16 512×1024 train step
(16, 1024, 64, 128) bf16 channels_last, rate 0.1.

  python tools/dropout_bench_torch.py [--tree DIR] [--n 100]

Prints the card (name, power limit, SM clock) and one JSON line: the
wrapper's ms (CUDA events, median of n calls after 3 warm-up ones) and the
kernel's device ms (torch.profiler, mean of 20 calls) at element offset 0
and, where the tree's wrapper takes an offset, at offsets 1 and a rank's
shard (half the tensor); each output bit-equal to the plain version, the
bound (the bytes read and written over 3.35 TB/s). `--tree` times another
checkout's wrapper (the parent's, unpacked with `git archive` into a
git-ignored directory); compare two trees in one call, in turns: parent,
change, change, parent, each its own process.
"""

import argparse
import inspect
import json
import sys

import torch

from bench_util_torch import HBM_BYTES_PER_S, cuda_ms, device_ms, open_tree, print_card

SHAPE = (16, 1024, 64, 128)
DROP = 26  # round(0.1 · 256)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="the checkout whose wrapper to time")
    ap.add_argument("--n", type=int, default=100)
    args = ap.parse_args(argv)
    tree = open_tree(args.tree, "dropout_bench_torch")
    print_card()
    from mds_tpu_torch.ops.dropout import dropout_u8, dropout_u8_plain

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(SHAPE, device="cuda", generator=gen).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    k0, k1 = 12345, 6789
    offsets = [0]
    if "offset" in inspect.signature(dropout_u8).parameters:
        offsets += [1, x.numel() // 2]
    out = {"tree": str(tree), "shape": list(SHAPE),
           "bound_ms": 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3}
    for off in offsets:
        extra = (off,) if off else ()
        got = dropout_u8(x, k0, k1, DROP, *extra)
        want = dropout_u8_plain(x, k0, k1, DROP, *extra)
        out[f"offset_{off}"] = {
            "bit_equal": bool(torch.equal(got.view(torch.int16), want.view(torch.int16))),
            "ms": cuda_ms(lambda: dropout_u8(x, k0, k1, DROP, *extra), n=args.n),
            "device_ms": device_ms(lambda: dropout_u8(x, k0, k1, DROP, *extra),
                                   "dropout", n=20)}
        del got, want
    print(json.dumps(out), flush=True)
    if not all(v["bit_equal"] for k, v in out.items() if k.startswith("offset_")):
        sys.exit("dropout_bench_torch: the kernel is not its plain version")
    return out


if __name__ == "__main__":
    main()
