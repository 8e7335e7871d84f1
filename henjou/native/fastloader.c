/* Native asset-decode kernels (the reference's loader layer is C++ with
 * stb_image/tinyobjloader — include/renderer/texture.h:23-38; this is the
 * equivalent native fast path for this renderer's host pipeline).
 *
 * Exposed via ctypes (no pybind11 in this image):
 *   png_unfilter : per-scanline PNG filter reconstruction (the only
 *                  serial part of PNG decode; zlib itself is C already)
 *   hdr_decode_rle : Radiance RGBE new-style RLE scanline decode
 *   rgbe_to_float : RGBE -> linear float RGB conversion
 */

#include <math.h>
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

static uint8_t paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return (uint8_t)a;
    if (pb <= pc) return (uint8_t)b;
    return (uint8_t)c;
}

/* raw: decompressed IDAT, one filter byte + stride bytes per scanline.
 * out: h*stride bytes. Returns 0 on success, -1 on bad filter type. */
int png_unfilter(const uint8_t *raw, uint8_t *out, int64_t h, int64_t stride,
                 int bypp) {
    const uint8_t *prev = NULL;
    for (int64_t y = 0; y < h; y++) {
        uint8_t ftype = raw[y * (stride + 1)];
        const uint8_t *line = raw + y * (stride + 1) + 1;
        uint8_t *cur = out + y * stride;
        switch (ftype) {
        case 0:
            memcpy(cur, line, stride);
            break;
        case 1: /* sub */
            for (int64_t x = 0; x < stride; x++) {
                uint8_t a = x >= bypp ? cur[x - bypp] : 0;
                cur[x] = (uint8_t)(line[x] + a);
            }
            break;
        case 2: /* up */
            for (int64_t x = 0; x < stride; x++) {
                uint8_t b = prev ? prev[x] : 0;
                cur[x] = (uint8_t)(line[x] + b);
            }
            break;
        case 3: /* average */
            for (int64_t x = 0; x < stride; x++) {
                uint8_t a = x >= bypp ? cur[x - bypp] : 0;
                uint8_t b = prev ? prev[x] : 0;
                cur[x] = (uint8_t)(line[x] + ((a + b) >> 1));
            }
            break;
        case 4: /* paeth */
            for (int64_t x = 0; x < stride; x++) {
                uint8_t a = x >= bypp ? cur[x - bypp] : 0;
                uint8_t b = prev ? prev[x] : 0;
                uint8_t c = (prev && x >= bypp) ? prev[x - bypp] : 0;
                cur[x] = (uint8_t)(line[x] + paeth(a, b, c));
            }
            break;
        default:
            return -1;
        }
        prev = cur;
    }
    return 0;
}

/* Radiance HDR: decode all scanlines (new-style RLE or flat) into
 * out[h*w*4] RGBE bytes. Returns bytes consumed, or -1 on error. */
int64_t hdr_decode_rle(const uint8_t *raw, int64_t raw_len, uint8_t *out,
                       int64_t w, int64_t h) {
    int64_t offs = 0;
    for (int64_t y = 0; y < h; y++) {
        uint8_t *row = out + y * w * 4;
        if (offs + 4 > raw_len) return -1;
        if (w >= 8 && w < 32768 && raw[offs] == 2 && raw[offs + 1] == 2 &&
            (((int64_t)raw[offs + 2] << 8) | raw[offs + 3]) == w) {
            offs += 4;
            for (int c = 0; c < 4; c++) {
                int64_t x = 0;
                while (x < w) {
                    if (offs >= raw_len) return -1;
                    int count = raw[offs++];
                    if (count > 128) { /* run */
                        count -= 128;
                        if (offs >= raw_len || x + count > w) return -1;
                        uint8_t v = raw[offs++];
                        for (int k = 0; k < count; k++) row[(x + k) * 4 + c] = v;
                        x += count;
                    } else { /* literal */
                        if (offs + count > raw_len || x + count > w) return -1;
                        for (int k = 0; k < count; k++)
                            row[(x + k) * 4 + c] = raw[offs++];
                        x += count;
                    }
                }
            }
        } else { /* flat */
            if (offs + w * 4 > raw_len) return -1;
            memcpy(row, raw + offs, w * 4);
            offs += w * 4;
        }
    }
    return offs;
}

/* RGBE -> float RGB: rgb = mantissa * 2^(e - 136) */
void rgbe_to_float(const uint8_t *rgbe, float *rgb, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        int e = rgbe[i * 4 + 3];
        if (e == 0) {
            rgb[i * 3] = rgb[i * 3 + 1] = rgb[i * 3 + 2] = 0.0f;
        } else {
            float f = ldexpf(1.0f, e - 136);
            rgb[i * 3] = rgbe[i * 4] * f;
            rgb[i * 3 + 1] = rgbe[i * 4 + 1] * f;
            rgb[i * 3 + 2] = rgbe[i * 4 + 2] * f;
        }
    }
}
