"""A JPEG round trip of an 8-bit RGB image as libjpeg-turbo computes it
with OpenCV's defaults (`cv2.imencode(".jpg", ..., IMWRITE_JPEG_QUALITY q)`
then `cv2.imdecode`), in numpy integer arithmetic and with no codec.

Entropy coding is lossless, so the round trip is the rest of the codec:

Each DCT pass is integer-linear up to its final descale, so it runs as an
exact int64 product with the matrix its butterfly gives, then the descale.

- encoder: `jccolor`'s fixed-point RGB -> YCbCr (16-bit fractions); the
  edge replication of `jcprepct` / `jcsample` (columns to whole blocks, rows
  to the row group, downsampled rows to the iMCU); `h2v2_downsample` (4:2:0,
  the rounding bias alternating 1, 2 along a row); `jfdctint`'s islow
  forward DCT; quantisation by the IJG tables scaled by
  `jpeg_quality_scaling` (baseline, clamped to 255), through libjpeg-turbo's
  reciprocal multiply (`compute_reciprocal`);
- decoder: dequantisation; `jidctint`'s islow inverse DCT with its range
  limit; `h2v2_fancy_upsample` (the triangle filter, the edge rows and
  columns replicated); `jdcolor`'s YCbCr -> RGB.

Every 8 x 8 block goes through each stage at once.
"""

from __future__ import annotations

import functools

import numpy as np

LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99], np.int64)
CHROMA = np.full(64, 99, np.int64)
CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = [17, 18, 24, 47, 18, 21, 26, 66,
                                                          24, 26, 56, 47, 66]

SCALEBITS, CONST_BITS, PASS1_BITS = 16, 13, 2
ONE_HALF = 1 << (SCALEBITS - 1)


def _fix(x: float, bits: int = SCALEBITS) -> int:
    return int(x * (1 << bits) + 0.5)


# jfdctint / jidctint's constants, FIX(x) at CONST_BITS
F0298, F0390, F0541, F0765 = 2446, 3196, 4433, 6270
F0899, F1175, F1501, F1847 = 7373, 9633, 12299, 15137
F1961, F2053, F2562, F3072 = 16069, 16819, 20995, 25172


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """`jpeg_set_quality(cinfo, quality, force_baseline=TRUE)`'s table."""
    quality = min(max(int(quality), 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - quality * 2
    return np.clip((base * scale + 50) // 100, 1, 255)


def _rgb_to_ycc(rgb: np.ndarray):
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    off = (128 << SCALEBITS) + ONE_HALF - 1
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b + off) >> SCALEBITS
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b + off) >> SCALEBITS
    return y, cb, cr


def _pad_edge(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, rows - h), (0, cols - w)), mode="edge")


def _blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(blocks: np.ndarray) -> np.ndarray:
    nby, nbx = blocks.shape[:2]
    return blocks.transpose(0, 2, 1, 3).reshape(nby * 8, nbx * 8)


def _fdct_butterfly(d: list, last: bool) -> tuple:
    """One pass of `jpeg_fdct_islow` on the 8 inputs `d`: its 8 outputs
    before their descale, and each one's descale shift (0: none); `last` is
    the column pass, which removes PASS1_BITS and leaves the factor 8."""
    tmp0, tmp7 = d[0] + d[7], d[0] - d[7]
    tmp1, tmp6 = d[1] + d[6], d[1] - d[6]
    tmp2, tmp5 = d[2] + d[5], d[2] - d[5]
    tmp3, tmp4 = d[3] + d[4], d[3] - d[4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if last:
        out[0], out[4] = tmp10 + tmp11, tmp10 - tmp11
    else:
        out[0], out[4] = (tmp10 + tmp11) << PASS1_BITS, (tmp10 - tmp11) << PASS1_BITS
    z1 = (tmp12 + tmp13) * F0541
    out[2] = z1 + tmp13 * F0765
    out[6] = z1 - tmp12 * F1847
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * F1175
    tmp4, tmp5, tmp6, tmp7 = tmp4 * F0298, tmp5 * F2053, tmp6 * F3072, tmp7 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    out[7], out[5] = tmp4 + z1 + z3, tmp5 + z2 + z4
    out[3], out[1] = tmp6 + z2 + z3, tmp7 + z1 + z4
    shift = CONST_BITS + PASS1_BITS if last else CONST_BITS - PASS1_BITS
    even = PASS1_BITS if last else 0
    return out, [even, shift, shift, shift, even, shift, shift, shift]


def _idct_butterfly(d: list, shift: int) -> tuple:
    """One pass of `jpeg_idct_islow` on the 8 inputs `d`: its 8 outputs
    before their descale by `shift`, and the shifts."""
    z1 = (d[2] + d[6]) * F0541
    tmp2, tmp3 = z1 - d[6] * F1847, z1 + d[2] * F0765
    tmp0, tmp1 = (d[0] + d[4]) << CONST_BITS, (d[0] - d[4]) << CONST_BITS
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    tmp0, tmp1, tmp2, tmp3 = d[7], d[5], d[3], d[1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * F1175
    tmp0, tmp1, tmp2, tmp3 = tmp0 * F0298, tmp1 * F2053, tmp2 * F3072, tmp3 * F1501
    z1, z2 = z1 * -F0899, z2 * -F2562
    z3, z4 = z3 * -F1961 + z5, z4 * -F0390 + z5
    tmp0, tmp1 = tmp0 + z1 + z3, tmp1 + z2 + z4
    tmp2, tmp3 = tmp2 + z2 + z3, tmp3 + z1 + z4
    return [tmp10 + tmp3, tmp11 + tmp2, tmp12 + tmp1, tmp13 + tmp0,
            tmp13 - tmp0, tmp12 - tmp1, tmp11 - tmp2, tmp10 - tmp3], [shift] * 8


@functools.cache
def _pass(kind: str, arg) -> tuple:
    """A DCT pass as (M, shifts): its outputs before the descale are
    integer-linear in its inputs, x @ M exactly in int64, then each output
    j descaled by shifts[j]."""
    fn = _fdct_butterfly if kind == "fdct" else _idct_butterfly
    out, shifts = fn(list(np.eye(8, dtype=np.int64)), arg)
    return np.stack(out, axis=-1), np.array(shifts, np.int64)


def _dct_pass(x: np.ndarray, kind: str, arg) -> np.ndarray:
    """The pass along the last axis of `x` (..., 8)."""
    M, shifts = _pass(kind, arg)
    y = x @ M
    half = np.where(shifts > 0, np.left_shift(1, np.maximum(shifts - 1, 0)), 0)
    return (y + half) >> shifts


def _reciprocals(divisors: np.ndarray):
    """libjpeg-turbo's `compute_reciprocal` for 16-bit DCT elements:
    (reciprocal, correction, shift) such that (|x| + c) * r >> s is the
    quantised |x|."""
    recip, corr, shift = [], [], []
    for q in divisors.tolist():
        b = q.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, q)
        c = q // 2
        if fr == 0:  # a power of two
            fq >>= 1
            r -= 1
        elif fr <= q // 2:
            c += 1
        else:
            fq += 1
        recip.append(fq), corr.append(c), shift.append(r)
    return (np.array(recip, np.int64).reshape(8, 8), np.array(corr, np.int64).reshape(8, 8),
            np.array(shift, np.int64).reshape(8, 8))


# jidctint's post-IDCT range limit: index (x & 1023) -> clamp(x + 128)
# for |x| < 512, wrapping beyond as libjpeg's table does
_IDCT_LIMIT = np.concatenate([np.arange(128, 256), np.full(384, 255), np.zeros(384),
                              np.arange(0, 128)]).astype(np.int64)


def _code_plane(plane: np.ndarray, qtable: np.ndarray) -> np.ndarray:
    """Forward DCT, quantisation, dequantisation and inverse DCT of every
    block of a (8m, 8n) plane of samples; returns the decoded samples."""
    blocks = _blocks(plane - 128)
    coef = _dct_pass(_dct_pass(blocks, "fdct", False).swapaxes(-1, -2), "fdct", True).swapaxes(-1, -2)
    recip, corr, shift = _reciprocals(qtable << 3)
    quant = np.sign(coef) * (((np.abs(coef) + corr) * recip) >> shift)
    deq = quant * qtable.reshape(8, 8)
    ws = _dct_pass(deq.swapaxes(-1, -2), "idct", CONST_BITS - PASS1_BITS).swapaxes(-1, -2)
    out = _IDCT_LIMIT[_dct_pass(ws, "idct", CONST_BITS + PASS1_BITS + 3) & 1023]
    return _unblocks(out)


def _fancy_upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """`h2v2_fancy_upsample` of a (ceil(h/2), ceil(w/2)) plane to (h, w)."""
    up = np.concatenate([c[:1], c[:-1]], axis=0)
    down = np.concatenate([c[1:], c[-1:]], axis=0)
    colsum = np.stack([3 * c + up, 3 * c + down], axis=1).reshape(-1, c.shape[1])
    left = np.concatenate([colsum[:, :1], colsum[:, :-1]], axis=1)
    right = np.concatenate([colsum[:, 1:], colsum[:, -1:]], axis=1)
    out = np.stack([(3 * colsum + left + 8) >> 4, (3 * colsum + right + 7) >> 4], axis=2)
    return out.reshape(colsum.shape[0], -1)[:h, :w]


def _ycc_to_rgb(y, cb, cr) -> np.ndarray:
    cb, cr = cb - 128, cr - 128
    r = y + ((_fix(1.402) * cr + ONE_HALF) >> SCALEBITS)
    g = y + ((-_fix(0.34414) * cb + ONE_HALF - _fix(0.71414) * cr) >> SCALEBITS)
    b = y + ((_fix(1.772) * cb + ONE_HALF) >> SCALEBITS)
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def jpeg_round_trip(rgb: np.ndarray, quality: int) -> np.ndarray:
    """(h, w, 3) uint8 RGB encoded at `quality` (4:2:0, islow) and decoded."""
    h, w = rgb.shape[:2]
    y, cb, cr = _rgb_to_ycc(rgb)
    # luma: whole blocks, edges replicated (rows beyond them are dummy blocks)
    ly = _code_plane(_pad_edge(y, -(-h // 8) * 8, -(-w // 8) * 8), quant_table(LUMA, quality))[:h, :w]
    # chroma: full-resolution columns to twice the chroma blocks' width, rows
    # to the row group (2), downsampled, then rows to the chroma block height
    ch, cw = -(-h // 2), -(-w // 2)
    cols = -(-cw // 8) * 16
    bias = np.tile([1, 2], cols // 2)
    qc = quant_table(CHROMA, quality)
    planes = []
    for c in (cb, cr):
        c = _pad_edge(c, 2 * ch, cols)
        c = (c[0::2, 0::2] + c[0::2, 1::2] + c[1::2, 0::2] + c[1::2, 1::2] + bias[: cols // 2]) >> 2
        c = _code_plane(_pad_edge(c, -(-ch // 8) * 8, cols // 2), qc)[:ch, :cw]
        planes.append(_fancy_upsample(c, h, w))
    return _ycc_to_rgb(ly, *planes)
