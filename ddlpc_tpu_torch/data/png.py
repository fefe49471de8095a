"""PNG decoding and encoding with the standard library's zlib and numpy.

The card's machine has no image library, so the port reads the tile and
scene PNGs of ``prepare_* --format png`` itself.  :func:`decode_png` covers
8-bit non-interlaced images of colour type gray, gray+alpha, RGB, RGBA and
palette (expanded to RGB), under all five row filters, and returns the
array imageio returns for the same file: ``[H, W]`` for gray, ``[H, W, 2]``,
``[H, W, 3]`` or ``[H, W, 4]`` otherwise, uint8.  Anything else (another
bit depth, interlacing, a palette with transparency, a bad CRC) raises
:class:`PNGError`; nothing is decoded approximately.

Filtered rows depend on the pixel to their left, which a row-wise numpy
pass cannot express for the Average and Paeth filters; they are
unfiltered along anti-diagonals instead (a pixel needs only its left,
upper and upper-left neighbours, which all lie on earlier diagonals), so
an image takes H + W vectorised steps rather than H·W scalar ones.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (palette: one index)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


class PNGError(ValueError):
    """A PNG the decoder does not cover, or a damaged one."""


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == SIGNATURE


def read_png(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    try:
        return decode_png(data)
    except PNGError as e:
        raise PNGError(f"{path}: {e}") from None


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos < len(data):
        if pos + 12 > len(data):
            raise PNGError("truncated chunk")
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise PNGError(f"truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise PNGError(f"bad CRC on the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise PNGError("no IEND chunk")


def decode_png(data: bytes) -> np.ndarray:
    """The pixels of one PNG file's bytes (see the module docstring)."""
    if data[:8] != SIGNATURE:
        raise PNGError("not a PNG file")
    header = None
    idat = []
    palette = None
    transparency = False
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            transparency = True
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise PNGError("no IHDR chunk")
    w, h, depth, color, compression, filter_method, interlace = header
    if color not in _CHANNELS:
        raise PNGError(f"colour type {color} is not a PNG colour type")
    if depth != 8:
        raise PNGError(f"bit depth {depth} (the decoder covers 8-bit images only)")
    if interlace != 0:
        raise PNGError("an interlaced image (the decoder covers non-interlaced images only)")
    if compression != 0 or filter_method != 0:
        raise PNGError(f"compression method {compression}, filter method {filter_method}")
    if color == 3 and (palette is None or transparency):
        raise PNGError("a palette image without PLTE, or with transparency (tRNS)")
    bpp = _CHANNELS[color]
    stride = w * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"corrupt image data ({e})") from None
    if len(raw) != h * (stride + 1):
        raise PNGError(f"{len(raw)} bytes of image data, expected {h * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    pixels = unfilter(rows[:, 0], rows[:, 1:].reshape(h, w, bpp))
    if color == 3:
        if pixels.max(initial=0) >= len(palette):
            raise PNGError("a palette index past the end of PLTE")
        return palette[pixels[..., 0]]
    return pixels[..., 0] if bpp == 1 else pixels


def unfilter(filters: np.ndarray, filtered: np.ndarray) -> np.ndarray:
    """Undo the row filters: ``filters [H]`` (0 None, 1 Sub, 2 Up, 3
    Average, 4 Paeth) over ``filtered [H, W, bpp]`` uint8."""
    if filters.size and filters.max() > 4:
        raise PNGError(f"row filter type {int(filters.max())}")
    h, w, bpp = filtered.shape
    if not filters.any():  # the port's own encoder writes filter 0 only
        return filtered.copy()
    # Anti-diagonals: out[y, x] needs out[y, x-1], out[y-1, x] and
    # out[y-1, x-1]; every pixel of diagonal d = y + x depends only on
    # diagonals d-1 and d-2.  A zero border row and column stand for the
    # neighbours outside the image.
    out = np.zeros((h + 1, w + 1, bpp), np.int32)
    src = filtered.astype(np.int32)
    kinds = filters.astype(np.int32)
    for d in range(h + w - 1):
        ys = np.arange(max(0, d - w + 1), min(h, d + 1))
        xs = d - ys
        a = out[ys + 1, xs]
        b = out[ys, xs + 1]
        c = out[ys, xs]
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        k = kinds[ys][:, None]
        pred = np.select([k == 1, k == 2, k == 3, k == 4], [a, b, (a + b) >> 1, paeth], 0)
        out[ys + 1, xs + 1] = (src[ys, xs] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8)


_COLOR_OF_CHANNELS = {1: 0, 2: 4, 3: 2, 4: 6}


def encode_png(pixels: np.ndarray, level: int = 6) -> bytes:
    """``pixels`` uint8 ``[H, W]`` (gray) or ``[H, W, 2|3|4]`` as an 8-bit
    PNG, filter 0 on every row, one zlib stream at ``level``."""
    a = np.ascontiguousarray(pixels)
    if a.ndim == 2:
        a = a[..., None]
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in _COLOR_OF_CHANNELS:
        raise ValueError(f"expected [H, W] or [H, W, 1-4] uint8, got {pixels.shape} {pixels.dtype}")
    h, w, c = a.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, w * c)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_OF_CHANNELS[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + _chunk(b"IEND", b""))


def write_png(path: str, pixels: np.ndarray, level: int = 6) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(pixels, level))


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))
