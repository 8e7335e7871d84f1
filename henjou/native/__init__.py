"""Native (C) host runtime: fast asset decode with ctypes bindings.

The reference's loader/runtime layer is native C++ (tinygltf /
tinyobjloader / stb_image, SURVEY.md §2.2); here the host-side hot loops
(PNG filter reconstruction, HDR RLE) are C compiled on first use and
loaded via ctypes — pure-python fallbacks keep everything working when no
compiler is available.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile

import numpy as np

log = logging.getLogger("henjou")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "fastloader.c")
_LIB = None
_TRIED = False


def _build_lib():
    so_path = os.path.join(_HERE, "_fastloader.so")
    if not os.path.exists(so_path) or os.path.getmtime(so_path) < os.path.getmtime(
        _SRC
    ):
        with tempfile.TemporaryDirectory() as td:
            tmp_so = os.path.join(td, "_fastloader.so")
            subprocess.run(
                ["cc", "-O2", "-fPIC", "-shared", "-o", tmp_so, _SRC, "-lm"],
                check=True,
                capture_output=True,
            )
            os.replace(tmp_so, so_path)
    lib = ctypes.CDLL(so_path)
    lib.png_unfilter.restype = ctypes.c_int
    lib.png_unfilter.argtypes = [
        ctypes.c_char_p,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int,
    ]
    lib.hdr_decode_rle.restype = ctypes.c_int64
    lib.hdr_decode_rle.argtypes = [
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_void_p,
        ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.rgbe_to_float.restype = None
    lib.rgbe_to_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    return lib


def get_lib():
    """The compiled library, or None when unavailable."""
    global _LIB, _TRIED
    if _LIB is None and not _TRIED:
        _TRIED = True
        try:
            _LIB = _build_lib()
        except (OSError, subprocess.CalledProcessError) as e:
            log.warning("native fastloader unavailable, using python: %s", e)
    return _LIB


def png_unfilter(raw: bytes, h: int, stride: int, bypp: int):
    """PNG scanline reconstruction -> [h, stride] uint8, or None to fall
    back to python."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((h, stride), np.uint8)
    rc = lib.png_unfilter(raw, out.ctypes.data, h, stride, bypp)
    if rc != 0:
        raise ValueError("bad PNG filter type")
    return out


def hdr_decode(raw: bytes, w: int, h: int):
    """Radiance RLE decode + float conversion -> [h,w,3] f32, or None."""
    lib = get_lib()
    if lib is None:
        return None
    rgbe = np.empty((h, w, 4), np.uint8)
    consumed = lib.hdr_decode_rle(raw, len(raw), rgbe.ctypes.data, w, h)
    if consumed < 0:
        raise ValueError("corrupt HDR RLE stream")
    rgb = np.empty((h, w, 3), np.float32)
    lib.rgbe_to_float(rgbe.ctypes.data, rgb.ctypes.data, w * h)
    return rgb
