"""ctypes bindings to the repo's native preprocessing library,
cpp/mdspre.cpp — the port's own copy of the parts of mds_tpu/data/native.py
that the data layer calls: JPEG/PNG decode and the one-pass fused train
augment (resize, pad, crop, flip, jitter, label table).

The library is built at first use with g++ and cpp/Makefile's flags into
the git-ignored mds_tpu_torch/build/ (never into cpp/), written under a
temporary name and moved into place, so processes that build at once do
not read a half-written file. Without a compiler or the libjpeg/libpng
headers `get_lib` returns None and the callers take the numpy path, as the
JAX package's do.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_ROOT, "cpp", "mdspre.cpp")
_BUILD_DIR = os.path.join(_ROOT, "mds_tpu_torch", "build")
_SO_PATH = os.path.join(_BUILD_DIR, "libmdspre.so")
# cpp/Makefile's CXXFLAGS and LIBS
_CXX_CMD = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-march=native"]
_LIBS = ["-ljpeg", "-lpng"]

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()
# why the library could not be built, once a build has failed
build_error: Optional[str] = None

u8p = ctypes.POINTER(ctypes.c_uint8)
i32p = ctypes.POINTER(ctypes.c_int32)


def _build() -> bool:
    global build_error
    os.makedirs(_BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(_CXX_CMD + ["-o", tmp, _SRC] + _LIBS, check=True,
                       capture_output=True, text=True, timeout=300)
        os.replace(tmp, _SO_PATH)
        return True
    except subprocess.CalledProcessError as e:
        lines = (e.stderr or "").strip().splitlines()
        first = next((ln for ln in lines if "error" in ln), f"exit {e.returncode}")
        build_error = first[:300]
        return False
    except (OSError, subprocess.SubprocessError) as e:
        build_error = str(e)[:300]
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The library, built on the first call; None where it cannot be."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not os.path.exists(_SO_PATH) and not _build():
            return None
        lib = ctypes.CDLL(_SO_PATH)
        lib.mdspre_decode_jpeg.restype = ctypes.c_int
        lib.mdspre_decode_jpeg.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, i32p, i32p]
        lib.mdspre_decode_png.restype = ctypes.c_int
        lib.mdspre_decode_png.argtypes = [
            u8p, ctypes.c_int64, u8p, ctypes.c_int64, i32p, i32p, ctypes.c_int32]
        lib.mdspre_fused_augment.restype = None
        lib.mdspre_fused_augment.argtypes = [
            u8p, u8p, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_float, ctypes.c_float, ctypes.c_float,
            u8p, u8p, u8p]
        _LIB = lib
        return _LIB


def available() -> bool:
    return get_lib() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(u8p)


def _decode(fn, data: bytes, channels: Optional[int]) -> Optional[np.ndarray]:
    """Two calls: the first reads the size, the second decodes into `out`."""
    buf = np.frombuffer(data, np.uint8)
    h, w = ctypes.c_int32(), ctypes.c_int32()
    extra = () if channels is None else (channels,)
    if fn(_ptr(buf), len(data), None, 0, ctypes.byref(h), ctypes.byref(w), *extra) != 0:
        return None
    shape = (h.value, w.value) if channels == 1 else (h.value, w.value, 3)
    out = np.empty(shape, np.uint8)
    rc = fn(_ptr(buf), len(data), _ptr(out), out.nbytes,
            ctypes.byref(h), ctypes.byref(w), *extra)
    return out if rc == 0 else None


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """RGB uint8 (H, W, 3), or None."""
    lib = get_lib()
    return None if lib is None else _decode(lib.mdspre_decode_jpeg, data, None)


def decode_png(data: bytes, channels: int = 1) -> Optional[np.ndarray]:
    """Gray uint8 (H, W) for channels=1, RGB (H, W, 3) for 3, or None."""
    lib = get_lib()
    return None if lib is None else _decode(lib.mdspre_decode_png, data, channels)


def fused_augment(im: np.ndarray, lb: np.ndarray,
                  resize_hw: Tuple[int, int], pad_hw: Tuple[int, int],
                  crop_off: Tuple[int, int], crop_hw: Tuple[int, int],
                  flip: bool, brightness: float, contrast: float, saturation: float,
                  lb_lut: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One-pass train augment (cpp/mdspre.cpp `mdspre_fused_augment`): im
    (H, W, 3) and lb (H, W) uint8 → the (crop_h, crop_w) crop of both."""
    lib = get_lib()
    im = np.ascontiguousarray(im, np.uint8)
    lb = np.ascontiguousarray(lb, np.uint8)
    if im.shape[:2] != lb.shape or im.ndim != 3 or im.shape[2] != 3:
        raise ValueError(f"fused_augment: im {im.shape} and lb {lb.shape}")
    lb_lut = np.ascontiguousarray(lb_lut.astype(np.uint8))
    if lb_lut.shape != (256,):
        raise ValueError(f"fused_augment: lb_lut must have 256 entries, got {lb_lut.shape}")
    ch, cw = crop_hw
    out_im = np.empty((ch, cw, 3), np.uint8)
    out_lb = np.empty((ch, cw), np.uint8)
    lib.mdspre_fused_augment(
        _ptr(im), _ptr(lb), im.shape[0], im.shape[1],
        resize_hw[0], resize_hw[1], pad_hw[0], pad_hw[1],
        crop_off[0], crop_off[1], ch, cw,
        1 if flip else 0, brightness, contrast, saturation,
        _ptr(lb_lut), _ptr(out_im), _ptr(out_lb))
    return out_im, out_lb
