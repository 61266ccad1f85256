#!/usr/bin/env python
"""Run the port's CUDA kernels on the CPU, without a card or nvcc.

  python tools/cuda_shim/rehearse.py [stem window pair detail stemblock stem7 conv3 tail
                                      depthwise upsample_argmax dropout]

Compiles the csrc/ sources the named checks need (all: stem.cu, stem7.cu,
conv3x3.cu, detail_tail.cu, depthwise.cu, upsample_argmax.cu, dropout.cu) with g++
against the stand-in CUDA runtime beside this script (one std::thread per
CUDA thread, std::barrier for __syncthreads, __syncwarp, named barriers and
wgmma's fence/commit/wait; wgmma m64nNk16 computed per warpgroup, its B read
through the descriptor's start and stride byte offsets and the 128-byte
swizzle on the address bits; ldmatrix from the exchanged row addresses;
mbarriers with arrival and transfer counts; cp.async (with zero fill) and
cp.async.bulk global to shared as copies; the tensor copy (TMA) of a 4-d
box as a copy through the tensor map that cuTensorMapEncodeTiled's
stand-in records, zeros outside the tensor, completing the box's bytes on
its mbarrier; an mbarrier wait that sees no phase change for 30 s aborts;
stmatrix to the exchanged row addresses; cp.async.bulk shared to global
held until the wait that completes its bulk group, so a stage written again
before its wait, or a missing final wait, shows), into the git-ignored
mds_tpu_torch/build/shim/. Then it
calls each kernel's wrapper on CPU tensors at small, ragged shapes, with the
wrappers made to launch (through ctypes, as on the card), and holds every
output to the kernel's plain version: rel max-diff < 1e-2 (1e-4 for the
stem's f32 training form), the window stem bit-equal to the single stem,
and the depthwise, upsample + argmax and dropout kernels bit for bit (the
dropout at element offsets 0-3 and past 2^32 counters). It finds
indexing, masking and tiling faults before a chip call; it says nothing of speed, of races between
threads or of what nvcc accepts. Exits 1 on any mismatch.
"""

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent.parent
SRC = ROOT / "mds_tpu_torch" / "csrc"
OUT = ROOT / "mds_tpu_torch" / "build" / "shim"
# the source each check needs
SOURCES = {"stem": "stem.cu", "window": "stem.cu", "pair": "stem.cu", "detail": "stem.cu",
           "stemblock": "stem.cu", "stem7": "stem7.cu", "conv3": "conv3x3.cu",
           "tail": "detail_tail.cu", "depthwise": "depthwise.cu",
           "upsample_argmax": "upsample_argmax.cu", "dropout": "dropout.cu"}

sys.path.insert(0, str(ROOT))


def build(sources) -> Path:
    """The sources as C++ for the stand-in runtime: the asm helpers swapped
    for mma_impl.h, dynamic shared memory and <<<...>>> launches rewritten;
    into a directory of their own under OUT."""
    out = OUT / ("all" if set(sources) == set(SOURCES.values())
                 else "-".join(Path(f).stem for f in sorted(sources)))
    out.mkdir(parents=True, exist_ok=True)
    m = (SRC / "mma.cuh").read_text()
    a, b = m.index("// Asynchronous copies into shared memory"), m.index("}  // namespace")
    (out / "mma.cuh").write_text(m[:a] + '#include "mma_impl.h"\n\n' + m[b:])
    g = (SRC / "wgmma.cuh").read_text()
    a, b = g.index("// -- PTX begin"), g.index("// -- PTX end")
    (out / "wgmma.cuh").write_text(g[:a] + '#include "wgmma_impl.h"\n' + g[b:])
    cpps = []
    for f in sorted(sources):
        s = (SRC / f).read_text()

        if '#include "mma.cuh"' not in s and '#include "wgmma.cuh"' not in s:
            s = s.replace("namespace {", '#include "mma_impl.h"\nnamespace {', 1)
        s = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?([\w ]+?) (\w+)\[\];",
                   r"\1* \2 = reinterpret_cast<\1*>(shim_smem());", s)
        # a block's static shared arrays: views of its shared memory, one
        # after the other
        s = re.sub(r"__shared__ __align__\(\d+\) (\w+) (\w+)((?:\[[^\]]+\])+);",
                   r"auto& \2 = *reinterpret_cast<\1(*)\3>(shim_static(sizeof(\1\3)));", s)
        s = re.sub(r"(\w+(?:<[\w, ]+>)?)<<<(.*?)>>>\(", r"shim_launch(\1, \2)(", s,
                   flags=re.S)
        cpp = out / (f[:-3] + ".cpp")
        cpp.write_text(s)
        cpps.append(str(cpp))
    lib = out / "libshim.so"
    res = subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-ffp-contract=off",
         "-fno-strict-aliasing", "-pthread", f"-I{HERE}", f"-I{out}", "-o",
         str(lib), str(HERE / "shim_rt.cpp"), *cpps],
        capture_output=True, text=True)
    if res.returncode:
        sys.exit(f"g++ failed:\n{res.stderr[-8000:]}")
    return lib


def main(which):
    import numpy as np
    import torch

    from mds_tpu_torch.ops import build as kbuild
    from mds_tpu_torch.ops import conv3x3, depthwise, stem
    from mds_tpu_torch.ops import dropout as dr
    from mds_tpu_torch.ops import upsample_argmax as ua

    lib = ctypes.CDLL(str(build({SOURCES[n] for n in which})))
    for name, argtypes in kbuild._SIGNATURES.items():
        if hasattr(lib, name):
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
    # the wrappers launch through the stand-in library on CPU tensors
    kbuild.load = lambda: lib
    stem._is_cpu = conv3x3._is_cpu = depthwise._is_cpu = ua._is_cpu = lambda x: False
    stem._stream = conv3x3._stream = depthwise._stream = ua._stream = \
        lambda: ctypes.c_void_p(0)
    dr._is_cpu, dr._stream = (lambda x: False), (lambda x: ctypes.c_void_p(0))

    rng = np.random.default_rng(0)

    def image(b, h, w, c=3):  # RGB as normalized, features after a ReLU
        x = torch.tensor(rng.normal(0, 1, (b, h, w, c)), dtype=torch.float32)
        return (x if c == 3 else x.relu()).to(torch.bfloat16).permute(0, 3, 1, 2)

    def conv_w(o, i, k=3):
        return torch.tensor(rng.normal(0, np.sqrt(2 / (o * k * k)), (o, i, k, k)),
                            dtype=torch.float32)

    def bn(n):
        return (torch.tensor(rng.normal(1, .1, n), dtype=torch.float32),
                torch.tensor(rng.normal(0, .1, n), dtype=torch.float32))

    failures = []

    def check(name, got, want, equal_to=None, tol=1e-2):
        r = ((got.float() - want.float()).abs().max()
             / want.float().abs().max().clamp_min(1e-12)).item()
        eq = (got == want).float().mean().item()
        ok = (got.shape == want.shape and got.dtype == want.dtype and r < tol
              and got.is_contiguous(memory_format=torch.channels_last)
              and (equal_to is None or torch.equal(got, equal_to)))
        print(f"{'ok ' if ok else 'BAD'} {name}: {tuple(got.shape)} rel {r:.3g} "
              f"equal {eq:.4f}", flush=True)
        if not ok:
            failures.append(name)

    t0 = time.time()
    if {"stem", "window"} & which:
        for b, h, w, o, relu in ((1, 18, 22, 64, True), (2, 10, 134, 16, False),
                                 (1, 2, 2, 8, True), (1, 4, 260, 128, True),
                                 (3, 6, 14, 24, False)):
            args = (image(b, h, w), conv_w(o, 3), *bn(o), relu)
            want = stem.stem_conv_bn_relu_s2_plain(*args)
            k1 = stem.stem_conv_bn_relu_s2(*args)
            check(f"stem {b, h, w, o}", k1, want)
            check(f"window {b, h, w, o}", stem.stem_conv_bn_relu_s2_window(*args),
                  want, equal_to=k1)
            # the training form: f32 out, the f32 gate
            x, k = args[0], args[1].to(torch.bfloat16)
            check(f"stem f32 {b, h, w, o}", stem.stem_conv3x3_s2(x, k),
                  stem.stem_conv3x3_s2_plain(x, k), tol=1e-4)
    if "pair" in which:
        # one strip; B = 2; two strips, the second 5 columns wide, B = 2; the
        # smallest image; three strips, the last 2 columns wide
        for b, h, w, relu2 in ((1, 20, 70, True), (2, 6, 10, False), (2, 10, 262, True),
                               (1, 2, 2, True), (1, 8, 508, False)):
            args = (image(b, h, w), conv_w(64, 3), *bn(64), conv_w(64, 64), *bn(64),
                    relu2)
            check(f"pair {b, h, w}", stem.stem_s1_pair_fused(*args),
                  stem.stem_s1_pair_fused_plain(*args))
    if "detail" in which:
        # one strip; two strips, the second 3 columns wide, B = 2; a strip
        # one column past 62; the smallest image
        for b, h, w in ((1, 16, 72), (2, 12, 260), (1, 20, 252), (1, 4, 4)):
            args = (image(b, h, w), conv_w(64, 3), *bn(64), conv_w(64, 64), *bn(64),
                    conv_w(64, 64), *bn(64))
            check(f"detail {b, h, w}", stem.detail_s1s2_fused(*args),
                  stem.detail_s1s2_fused_plain(*args))
    if "stemblock" in which:
        # one strip; B = 2 with a second strip 3 columns wide and H/4, W/4 off
        # any tile; the smallest image; three strips, the last one column
        for b, h, w in ((1, 12, 100), (2, 20, 256), (1, 4, 4), (1, 8, 492)):
            args = (image(b, h, w), conv_w(16, 3), *bn(16), conv_w(8, 16, 1), *bn(8),
                    conv_w(16, 8), *bn(16), conv_w(16, 32), *bn(16))
            check(f"stemblock {b, h, w}", stem.stemblock_fused(*args),
                  stem.stemblock_fused_plain(*args))
    if "stem7" in which:
        # ragged tiles, B = 2, O = 8 to 128 (x4, x2 and x1 stores), without
        # ReLU, the smallest image
        for b, h, w, o, relu in ((2, 18, 70, 32, True), (1, 10, 132, 64, False),
                                 (1, 6, 20, 24, True), (2, 4, 6, 8, False),
                                 (1, 8, 136, 128, True), (1, 2, 2, 56, True)):
            args = (image(b, h, w), conv_w(o, 3, 7), *bn(o), relu)
            check(f"stem7 {b, h, w, o}", stem.stem7_conv_bn_relu_s2(*args),
                  stem.stem7_conv_bn_relu_s2_plain(*args))
    if "conv3" in which:
        for b, h, w, ci, co, relu in ((1, 9, 40, 64, 64, True), (2, 5, 7, 32, 16, False),
                                      (1, 11, 33, 3, 8, True), (1, 6, 20, 24, 136, True)):
            args = (image(b, h, w, ci), conv_w(co, ci), *bn(co), relu)
            check(f"conv3 {b, h, w, ci, co}", conv3x3.conv3x3_bn_relu(*args),
                  conv3x3.conv3x3_bn_relu_plain(*args))
    if "tail" in which:
        for b, h4, w4 in ((1, 16, 16), (2, 22, 38), (1, 34, 46)):
            params = []
            for o, i in stem._TAIL_SHAPES:
                params += [conv_w(o, i), *bn(o)]
            args = (image(b, h4, w4, 64), *params)
            check(f"tail {b, h4, w4}", stem.detail_tail_fused(*args),
                  stem.detail_tail_fused_plain(*args))
    if "depthwise" in which:
        # m = 6 and 4 (two input channels per group of 8 outputs), 2, 3 and 5
        # (four) on kernel 9's staged form; m = 1 at 4, 2 and 1 pixels per
        # thread; f32 and C % 8 != 0 on its scalar path. Kernel 10 at every
        # stride-1 shape: on its TMA form where C * size % 16 == 0, else its
        # masked form (C = 12, 20 in bf16); beyond the first: more tiles than
        # one pass of SHIM_SMS blocks walks, ragged right and bottom, at m = 1
        # (C = 64: 4x32 tiles) and m = 6 (C = 32: 1x32), B = 2; an image
        # smaller than a tile; f32 at m = 1, 3 and 6 (C = 20: 4-channel
        # runs); m = 2 and 3 with C = 16; m = 5, 7, 8, 11 and 12 (a thread
        # 5, 7, 8, 1 and 6 outputs of a channel). Bit for bit.
        for b, c, h, w, m, s, dt in (
                (1, 16, 9, 37, 6, 1, torch.bfloat16), (2, 16, 11, 70, 6, 2, torch.bfloat16),
                (1, 8, 6, 33, 4, 1, torch.bfloat16), (2, 8, 13, 70, 2, 2, torch.bfloat16),
                (1, 24, 5, 9, 3, 1, torch.bfloat16), (1, 8, 7, 12, 5, 2, torch.bfloat16),
                (2, 64, 33, 65, 1, 1, torch.bfloat16), (1, 16, 20, 40, 1, 2, torch.bfloat16),
                (1, 8, 3, 5, 1, 1, torch.bfloat16), (1, 16, 7, 9, 6, 1, torch.float32),
                (2, 12, 9, 10, 6, 2, torch.bfloat16),
                (2, 64, 19, 70, 1, 1, torch.bfloat16), (2, 32, 5, 45, 6, 1, torch.bfloat16),
                (1, 128, 6, 35, 1, 1, torch.bfloat16), (1, 32, 2, 3, 6, 1, torch.bfloat16),
                (2, 12, 7, 13, 1, 1, torch.bfloat16), (1, 20, 6, 9, 3, 1, torch.bfloat16),
                (2, 8, 11, 40, 1, 1, torch.float32), (1, 20, 5, 11, 3, 1, torch.float32),
                (2, 32, 3, 37, 6, 1, torch.float32), (1, 16, 9, 14, 2, 1, torch.bfloat16),
                (2, 16, 6, 21, 3, 1, torch.bfloat16), (1, 8, 5, 9, 12, 1, torch.bfloat16),
                (1, 8, 4, 7, 7, 1, torch.bfloat16), (1, 16, 3, 6, 11, 1, torch.bfloat16),
                (1, 8, 5, 6, 8, 1, torch.float32), (2, 24, 4, 11, 5, 1, torch.bfloat16)):
            x = image(b, h, w, c).to(dt)
            wt = torch.tensor(rng.normal(0, 0.3, (c * m, 1, 3, 3)), dtype=torch.float32).to(dt)
            want = depthwise.depthwise3x3_plain(x, wt, s)
            got = depthwise.depthwise3x3(x, wt, s)
            check(f"depthwise {b, c, h, w} m={m} s={s} {dt}", got, want, equal_to=want)
            if s == 1:
                check(f"depthwise_dma {b, c, h, w} m={m} {dt}", depthwise.depthwise3x3_dma(x, wt),
                      want, equal_to=got)
    if "upsample_argmax" in which:
        # C = 1, 19, 150 and 400 (classes staged in three chunks), s = 1, 3, 8
        # and 12 (two threads a run), bf16 and f32, B = 2, odd h and w, three
        # blocks of runs, a 1x1 input. Bit for bit.
        for b, c, h, w, s, dt in (
                (2, 19, 7, 9, 8, torch.bfloat16), (1, 1, 5, 11, 8, torch.bfloat16),
                (2, 150, 3, 5, 8, torch.float32), (1, 19, 6, 37, 3, torch.bfloat16),
                (2, 1, 9, 4, 1, torch.float32), (1, 150, 4, 7, 3, torch.bfloat16),
                (1, 19, 9, 70, 8, torch.float32), (1, 400, 3, 4, 8, torch.bfloat16),
                (1, 19, 5, 6, 1, torch.bfloat16), (2, 5, 3, 3, 12, torch.bfloat16),
                (1, 3, 1, 1, 8, torch.float32), (2, 19, 5, 3, 3, torch.float32)):
            lg = torch.tensor(rng.normal(0, 1, (b, h, w, c)), dtype=dt).permute(0, 3, 1, 2)
            got, want = ua.upsample_argmax(lg, s), ua.upsample_argmax_plain(lg, s)
            ok = got.shape == want.shape and got.dtype == want.dtype and torch.equal(got, want)
            print(f"{'ok ' if ok else 'BAD'} upsample_argmax {b, c, h, w} s={s} {dt}: "
                  f"differing {int((got != want).sum())}", flush=True)
            if not ok:
                failures.append(f"upsample_argmax {b, c, h, w, s}")
    if "dropout" in which:
        # bf16 (8 a vector) and f32 (4), at offsets 0-3 (each SH variant),
        # a rank's shard, and past 2^32 counters; a masked tail of 1-7
        # elements; each against the plain version bit for bit, and the
        # shard of a whole draw equal to that draw's rows
        for n, dt in ((1037, torch.bfloat16), (523, torch.float32), (64, torch.bfloat16),
                      (9, torch.float32)):
            x = torch.tensor(rng.normal(0, 1, n), dtype=torch.float32).to(dt)
            for off in (0, 1, 2, 3, 4 * 1037 + 2, (1 << 34) + 5):
                got = dr.dropout_u8(x, 12345, 678, 26, off)
                want = dr.dropout_u8_plain(x, 12345, 678, 26, off)
                ok = torch.equal(got.view(torch.uint8), want.view(torch.uint8))
                print(f"{'ok ' if ok else 'BAD'} dropout n={n} {dt} offset={off}: differing "
                      f"{int((got != want).sum())}", flush=True)
                if not ok:
                    failures.append(f"dropout {n, dt, off}")
            whole = dr.dropout_u8(torch.cat([x, x]), 7, 9, 26)
            ok = torch.equal(dr.dropout_u8(x, 7, 9, 26, n).view(torch.uint8),
                             whole[n:].view(torch.uint8))
            print(f"{'ok ' if ok else 'BAD'} dropout n={n} {dt}: second half = rows", flush=True)
            if not ok:
                failures.append(f"dropout rows {n, dt}")
    print(f"{time.time() - t0:.0f} s; " + (f"FAILED: {failures}" if failures else "all ok"))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main(set(sys.argv[1:]) or set(SOURCES)))
