"""Build and load the port's CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles every source under `mds_tpu_torch/csrc/` for sm_90a, one
process per source, all started together, and links the objects into one
shared library with a plain C interface, which ctypes loads. The library goes
into `mds_tpu_torch/build/` under a name that hashes the sources, the headers
they share (`*.cuh`) and the flags, so an edited source or header rebuilds
and an unchanged tree is reused. A missing
`nvcc` or a failed build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signatures of csrc/*.cu: pointers and the stream are void*, ints are int
# or long long, floats float
_SIGNATURES = {
    "mds_stem_conv_bn_relu_s2": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mds_stem_conv_bn_relu_s2_window": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mds_stem_s1_pair_fused": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "mds_detail_s1s2_fused": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "mds_detail_tail_fused": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mds_conv3x3_bn_relu": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mds_stemblock_fused": [_P, _P, _P, _P, _I, _I, _I, _P],
    "mds_stem7_conv_bn_relu_s2": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "mds_dropout_u8": [_P, _P, _L, _I, _L, _L, _I, _F, _L, _P],
    "mds_dw3x3": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    "mds_dw3x3_window": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "mds_upsample_argmax": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of mds_tpu_torch cannot be built")


def build() -> Path:
    """Compile csrc/*.cu into BUILD_DIR unless an up-to-date library is
    there; return its path. The compiler's output (ptxas register and shared
    memory use per kernel) is kept beside it as `<name>.log`."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {SRC_DIR}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources + sorted(SRC_DIR.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    lib = BUILD_DIR / f"libmds_kernels_{h.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [lib.with_name(f"{s.stem}.{tag}.o") for s in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(s)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for s, o in zip(sources, objs)]
    logs = [p.communicate()[0] for p in procs]
    failed = [(s.name, p.returncode) for s, p in zip(sources, procs) if p.returncode]
    tmp = lib.with_suffix(f".{tag}")
    if not failed:
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
                              *map(str, objs)], capture_output=True, text=True)
        logs.append(res.stdout + res.stderr)
        if res.returncode:
            failed.append(("link", res.returncode))
    log = "\n".join(logs)
    lib.with_suffix(".log").write_text(log)
    for o in objs:
        o.unlink(missing_ok=True)
    if failed:
        raise RuntimeError(f"nvcc failed {failed}:\n{log}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The kernel library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
