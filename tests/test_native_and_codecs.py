"""Native fastloader + image codec tests (PNG roundtrip incl. filtered
inputs, HDR RGBE decode, native-vs-python agreement)."""

import os
import struct
import zlib

import numpy as np
import pytest

from henjou.post.png import read_png, write_png


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, size=(33, 47, 3), dtype=np.uint8)
    p = str(tmp_path / "x.png")
    write_png(p, img)
    back = read_png(p)
    np.testing.assert_array_equal(img, back)


def test_png_rgba_and_gray(tmp_path):
    rng = np.random.default_rng(1)
    rgba = rng.integers(0, 256, size=(8, 8, 4), dtype=np.uint8)
    p = str(tmp_path / "a.png")
    write_png(p, rgba)
    np.testing.assert_array_equal(read_png(p), rgba)
    gray = rng.integers(0, 256, size=(8, 8), dtype=np.uint8)
    p2 = str(tmp_path / "g.png")
    write_png(p2, gray)
    np.testing.assert_array_equal(read_png(p2)[:, :, 0], gray)


def _png_with_filters(img, filters):
    """Encode with specific per-scanline filter types to exercise decode."""
    h, w, c = img.shape
    raw = b""
    prev = np.zeros(w * c, np.uint8)
    for y in range(h):
        line = img[y].reshape(-1).astype(np.int32)
        f = filters[y % len(filters)]
        if f == 0:
            enc = line
        elif f == 1:
            a = np.concatenate([np.zeros(c, np.int32), line[:-c]])
            enc = line - a
        elif f == 2:
            enc = line - prev
        elif f == 3:
            a = np.concatenate([np.zeros(c, np.int32), line[:-c]])
            enc = line - ((a + prev) // 2)
        else:
            raise ValueError
        raw += bytes([f]) + (enc & 0xFF).astype(np.uint8).tobytes()
        prev = line
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)

    def chunk(tag, data):
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw))
        + chunk(b"IEND", b"")
    )


def test_png_filtered_scanlines(tmp_path):
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, size=(16, 11, 3), dtype=np.uint8)
    data = _png_with_filters(img, [0, 1, 2, 3])
    p = tmp_path / "f.png"
    p.write_bytes(data)
    np.testing.assert_array_equal(read_png(str(p)), img)


def test_native_lib_builds():
    from henjou.native import get_lib

    lib = get_lib()
    assert lib is not None, "cc toolchain present in this image; must build"


def test_native_matches_python_unfilter():
    from henjou.native import png_unfilter

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, size=(9, 7, 3), dtype=np.uint8)
    data = _png_with_filters(img, [0, 1, 2, 3])
    # extract the raw stream again
    import io

    pos = 8
    idat = b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8 : pos + 8 + length]
        pos += 12 + length
    raw = zlib.decompress(idat)
    out = png_unfilter(raw, 9, 21, 3)
    np.testing.assert_array_equal(out.reshape(9, 7, 3), img)


def _write_hdr(path, rgb):
    """Minimal flat (non-RLE) Radiance writer for tests."""
    h, w, _ = rgb.shape
    maxv = rgb.max(axis=-1)
    e = np.zeros((h, w), np.int32)
    mant = np.zeros((h, w, 3), np.uint8)
    nz = maxv > 1e-32
    exp = np.ceil(np.log2(np.where(nz, maxv, 1.0))).astype(np.int32) + 1
    scale = np.exp2(8.0 - exp)
    mant = np.clip(rgb * np.where(nz, scale, 0.0)[..., None], 0, 255).astype(np.uint8)
    e = np.where(nz, exp + 128, 0).astype(np.uint8)
    rgbe = np.concatenate([mant, e[..., None]], axis=-1)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def test_hdr_decode(tmp_path):
    from henjou.texture.hdr import read_hdr

    rng = np.random.default_rng(4)
    # shared-exponent format: keep per-pixel channel ratios moderate, or
    # the writer's 8-bit mantissa floors small channels to zero
    base = rng.uniform(0.1, 20.0, size=(6, 16, 1))
    rgb = (base * rng.uniform(0.5, 1.0, size=(6, 16, 3))).astype(np.float32)
    p = str(tmp_path / "e.hdr")
    _write_hdr(p, rgb)
    back = read_hdr(p)
    assert back.shape == (6, 16, 3)
    # RGBE 8-bit mantissa quantization (+ the test writer truncates)
    np.testing.assert_allclose(back, rgb, rtol=0.04, atol=1e-3)


def test_texture_loading_and_atlas(tmp_path):
    from henjou.texture.atlas import build_atlas, sample_atlas
    from henjou.texture.texture import TexType, load_texture_cached

    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(8, 8, 3), dtype=np.uint8)
    write_png(str(tmp_path / "t.png"), img)
    textures, cache = [], {}
    tid = load_texture_cached(textures, cache, "t.png", str(tmp_path), TexType.NON_COLOR)
    assert tid == 0
    # dedupe
    assert load_texture_cached(textures, cache, "t.png", str(tmp_path), TexType.NON_COLOR) == 0
    # missing file -> -1
    assert load_texture_cached(textures, cache, "nope.png", str(tmp_path), TexType.SRGB) == -1

    import jax.numpy as jnp

    atlas = build_atlas(textures)
    # sample texel centers: exact values
    u = jnp.asarray([(0 + 0.5) / 8, (7 + 0.5) / 8])
    v = jnp.asarray([(0 + 0.5) / 8, (3 + 0.5) / 8])
    out = np.asarray(sample_atlas(atlas, jnp.asarray([0, 0]), u, v))
    np.testing.assert_allclose(out[0, :3], img[0, 0] / 255.0, atol=1e-6)
    np.testing.assert_allclose(out[1, :3], img[3, 7] / 255.0, atol=1e-6)
    # tex_id -1 -> white
    out2 = np.asarray(sample_atlas(atlas, jnp.asarray([-1]), u[:1], v[:1]))
    np.testing.assert_allclose(out2, 1.0)
