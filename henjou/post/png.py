"""Dependency-free PNG encode/decode.

The reference leans on stb_image / sutil::saveImage; this image has no
Pillow, so we implement the subset we need: 8/16-bit RGB(A)/gray,
non-interlaced, in pure python over zlib (decode covers the texture/LUT
assets the loaders consume; encode covers frame export,
renderer.h:1276-1303)."""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H,W,3|4] uint8 or [H,W] uint8."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError("write_png expects uint8")
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[c]
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 (None) per scanline
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))
    data = zlib.compress(raw, 6)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(_chunk(b"IHDR", ihdr))
        f.write(_chunk(b"IDAT", data))
        f.write(_chunk(b"IEND", b""))


def _paeth(a, b, c):
    p = a.astype(np.int32) + b.astype(np.int32) - c.astype(np.int32)
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    out = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return out.astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode 8/16-bit non-interlaced PNG to [H,W,C] uint8 (16-bit is
    truncated to the high byte). Palette images are expanded."""
    with open(path, "rb") as f:
        buf = f.read()
    return decode_png(buf, name=path)


def decode_png(buf: bytes, name: str = "<bytes>") -> np.ndarray:
    """read_png on an in-memory buffer (GLB bufferView / data-URI images)."""
    if buf[:8] != _MAGIC:
        raise ValueError(f"not a PNG: {name}")
    pos = 8
    idat = []
    palette = None
    trns = None
    w = h = bitdepth = color_type = None
    while pos < len(buf):
        (length,) = struct.unpack(">I", buf[pos : pos + 4])
        tag = buf[pos + 4 : pos + 8]
        data = buf[pos + 8 : pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            w, h, bitdepth, color_type, _, _, interlace = struct.unpack(
                ">IIBBBBB", data
            )
            if interlace:
                raise ValueError("interlaced PNG unsupported")
            if bitdepth not in (8, 16):
                raise ValueError(f"bitdepth {bitdepth} unsupported")
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(data, np.uint8)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    raw = zlib.decompress(b"".join(idat))

    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    bypp = channels * (bitdepth // 8)  # bytes per pixel
    stride = w * bypp

    # native fast path (henjou.native); python loop as fallback
    from henjou.native import png_unfilter as _native_unfilter

    out = _native_unfilter(raw, h, stride, bypp)
    if out is not None:
        return _expand_png(out, w, h, channels, bitdepth, color_type, palette, trns)

    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    offs = 0
    for y in range(h):
        ftype = raw[offs]
        line = np.frombuffer(raw, np.uint8, stride, offs + 1).copy()
        offs += 1 + stride
        if ftype == 0:
            cur = line
        elif ftype == 2:  # up
            cur = (line + prev).astype(np.uint8)
        else:
            # sub/average/paeth need a sequential pass over pixels
            cur = line
            for x in range(stride):
                a = int(cur[x - bypp]) if x >= bypp else 0
                b = int(prev[x])
                if ftype == 1:
                    cur[x] = (int(cur[x]) + a) & 0xFF
                elif ftype == 3:
                    cur[x] = (int(cur[x]) + ((a + b) >> 1)) & 0xFF
                elif ftype == 4:
                    c = int(prev[x - bypp]) if x >= bypp else 0
                    cur[x] = (
                        int(cur[x])
                        + int(_paeth(np.uint8(a), np.uint8(b), np.uint8(c)))
                    ) & 0xFF
                else:
                    raise ValueError(f"bad filter {ftype}")
        out[y] = cur
        prev = cur

    return _expand_png(out, w, h, channels, bitdepth, color_type, palette, trns)


def _expand_png(out, w, h, channels, bitdepth, color_type, palette, trns):
    img = out.reshape(h, w, channels * (bitdepth // 8))
    if bitdepth == 16:
        img = img.reshape(h, w, channels, 2)[:, :, :, 0]  # high byte
    else:
        img = img.reshape(h, w, channels)
    if color_type == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        rgb = palette[img[:, :, 0]]
        if trns is not None:
            alpha = np.full((h, w, 1), 255, np.uint8)
            npal = len(trns)
            alpha[:, :, 0] = np.where(
                img[:, :, 0] < npal, trns[np.minimum(img[:, :, 0], npal - 1)], 255
            )
            img = np.concatenate([rgb, alpha], axis=-1)
        else:
            img = rgb
    return img
