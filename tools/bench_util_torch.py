"""What the kernel bench tools (tools/stem_bench_torch.py,
tools/head_dw_bench_torch.py, tools/stem_block7_bench_torch.py,
tools/pred_pair_bench_torch.py) share: the
timers, the comparisons with a plain version, the tree they time (--tree)
and the builds of a csrc source with parts taken out (the split).

Imported by those tools, which run from tools/ (python tools/<tool>.py), so
this module sits beside them on sys.path.
"""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent.parent
# one H100 SXM (NVIDIA's data sheet)
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12


def open_tree(tree_arg, tool):
    """The checkout whose mds_tpu_torch the tool times (--tree, else this
    one), first on sys.path, its kernels built and TF32 off; exits without a
    CUDA device. Prints the tree and the ops.stem module it loaded."""
    if not torch.cuda.is_available():
        sys.exit(f"{tool}: no CUDA device")
    tree = Path(tree_arg).resolve() if tree_arg else ROOT
    sys.path.insert(0, str(tree))
    from mds_tpu_torch.ops import build, stem

    build.load()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"tree": str(tree), "stem_module": stem.__file__}), flush=True)
    return tree


def print_card():
    """The card's name, power limit and SM clock, as nvidia-smi gives them."""
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


def cuda_ms(fn, n=20):
    """Median of n CUDA-event times of fn() after 3 warm-up calls."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(n):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, key="", n=10):
    """Mean device time per call of the CUDA kernels whose name holds `key`
    (every kernel of the call for ""), by torch.profiler over n calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA
          and not e.is_user_annotation and key in e.name]
    total = sum(e.device_time_total for e in ev) / 1e3
    return total / n if ev and total > 0 else "not measured"


def rel(a, b):
    """max |a − b| / max |b|."""
    a, b = a.float(), b.float()
    return ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)).item()


def bits(t):
    """A bf16 or f32 NCHW tensor's bit patterns in NHWC order (-0 != +0)."""
    it = torch.int16 if t.dtype == torch.bfloat16 else torch.int32
    return t.permute(0, 2, 3, 1).contiguous().view(it)


def bit_equal(a, b):
    """The share of a's outputs bit-equal to b's."""
    return (bits(a) == bits(b)).float().mean().item()


def exact_plain(stem, plain, args):
    """plain(*args), a plain version of ops.stem, with every conv summed in
    f64 and rounded once to f32: the rounding points the kernel keeps, with
    exact sums."""
    real = stem._conv
    stem._conv = lambda x, w, b=None, stride=1, pad=1: F.conv2d(
        x.double(), w.double(), None if b is None else b.double(), stride=stride,
        padding=pad).float()
    try:
        return plain(*args)
    finally:
        stem._conv = real


def build_variants(src, variants, out_dir, skip=None):
    """nvcc of csrc/`src` (the tree's, with its headers) once per variant,
    each in out_dir/<name>/lib.so; {name: Popen}. `variants` maps a name to
    its patches, (file, anchor, replacement), each replacing every
    occurrence of its anchor; a variant is built where each anchor is found
    in the tree's sources (else it belongs to another design and is left
    out) and `skip(name, sources)` is not true."""
    from mds_tpu_torch.ops.build import NVCC_FLAGS, SRC_DIR, _nvcc

    procs = {}
    for name, patches in variants.items():
        srcs = {f.name: f.read_text() for f in SRC_DIR.glob("*.cuh")}
        srcs[src] = (SRC_DIR / src).read_text()
        if (any(old not in srcs[f] for f, old, _ in patches)
                or skip is not None and skip(name, srcs)):
            continue
        d = out_dir / name
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
        for f, old, new in patches:
            srcs[f] = srcs[f].replace(old, new)
        for f, text in srcs.items():
            (d / f).write_text(text)
        procs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-shared", "-o", str(d / "lib.so"), str(d / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def built(name, proc):
    """proc's nvcc log; exits with its tail if nvcc failed."""
    log = proc.communicate()[0]
    if proc.returncode:
        sys.exit(f"{name}: nvcc failed\n{log[-4000:]}")
    return log


def ptxas_lines(log, kernel=None):
    """ptxas's registers, spills, wgmma serialization (C75xx) and warnings,
    of `kernel`'s entries only (each after its mangled name) where one is
    named."""
    out, keep = [], kernel is None
    for ln in log.splitlines():
        if kernel is not None and ("Compiling entry function" in ln
                                   or "Function properties for" in ln):
            keep = kernel in ln
            if keep and "Compiling entry function" in ln:
                out.append(ln.split("'")[1] if "'" in ln else ln.strip())
        if keep and any(k in ln for k in ("registers", "spill", "C75", "warning")):
            out.append(ln.strip())
    return out
