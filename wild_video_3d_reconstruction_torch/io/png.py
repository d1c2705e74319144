"""PNG files without OpenCV: the port's counterpart of the `cv2.imread`
and `cv2.imwrite` calls its image directories need, so that a directory
of 8-bit PNGs is read and written with no image library (OpenCV is
optional for the port; the card's machine has 4.13).

`read_png` decodes non-interlaced 8-bit gray, gray + alpha, RGB and RGBA
PNGs with all five scanline filters, and gives what `cv2.imread` gives
bitwise: `IMREAD_COLOR` is BGR (gray repeated, alpha dropped),
`IMREAD_GRAYSCALE` is gray (a color image through libpng's own
rgb-to-gray, the weights OpenCV asks it for). Any other PNG (16-bit, a
palette, fewer than 8 bits, Adam7 interlacing, a transparency chunk, an
orientation or, for a color image read as gray, a gamma chunk) raises
`UnsupportedPNG` (a ValueError) naming what it met; `io/stream.py` hands
such files to `cv2.imread`. `write_png` writes gray or BGR uint8 that
`cv2.imread` reads back bitwise.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

IMREAD_GRAYSCALE = 0             # cv2's flag values
IMREAD_COLOR = 1

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}         # color type -> samples a pixel
_COLOR_NAMES = {0: "gray", 2: "RGB", 3: "palette", 4: "gray + alpha",
                6: "RGBA"}
# OpenCV reads a color PNG as gray through png_set_rgb_to_gray(png, 1,
# 0.299, 0.587): libpng takes the coefficients as 15-bit integers
# (floor(c * 32768)), gives blue the rest of 32768 and shifts without
# rounding. These are not cv2.cvtColor's BGR2GRAY weights (3735 / 19235
# / 9798, rounded): the two differ on about half of all pixels.
_GRAY_R, _GRAY_G = 9797, 19234
_GRAY_B = 32768 - _GRAY_R - _GRAY_G


class UnsupportedPNG(ValueError):
    """A valid PNG of a kind `read_png` does not decode."""


def _chunks(data):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IEND":
            return
    raise ValueError("PNG ends without an IEND chunk")


def _unfilter(raw, h, w, bpp):
    """Undo the per-scanline filters: raw [h, 1 + w * bpp] bytes ->
    [h, w, bpp] uint8. Rows filtered None / Sub / Up decode row by row,
    vectorised; an image with an Average or Paeth row decodes along its
    anti-diagonals (pixel (r, x) needs (r, x-1), (r-1, x), (r-1, x-1)),
    every pixel of one diagonal at once."""
    types = raw[:, 0]
    if types.max(initial=0) > 4:
        raise ValueError(f"PNG scanline filter type {int(types.max())}")
    f = raw[:, 1:].reshape(h, w, bpp)
    out = np.empty((h, w, bpp), np.uint8)
    if types.max(initial=0) <= 2:
        prev = np.zeros((w, bpp), np.uint8)
        for r in range(h):
            t = types[r]
            if t == 0:
                out[r] = f[r]
            elif t == 1:
                out[r] = np.cumsum(f[r], axis=0, dtype=np.uint8)
            else:
                out[r] = f[r] + prev
            prev = out[r]
        return out
    # recon[r + 1, x + 1] is pixel (r, x); row 0 and column 0 are the
    # zeros the filters see above the image and left of it
    rec = np.zeros((h + 1, w + 1, bpp), np.int32)
    fi = f.astype(np.int32)
    ti = types.astype(np.int32)
    for d in range(h + w - 1):
        r = np.arange(max(0, d - w + 1), min(h - 1, d) + 1)
        x = d - r
        a = rec[r + 1, x]
        b = rec[r, x + 1]
        c = rec[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ti[r][:, None]
        pred = np.where(t == 1, a, np.where(t == 2, b, np.where(
            t == 3, (a + b) >> 1, np.where(t == 4, paeth, 0))))
        rec[r + 1, x + 1] = (fi[r, x] + pred) & 0xFF
    out[:] = rec[1:, 1:]
    return out


def read_png(path, flags=IMREAD_COLOR):
    """uint8 [H, W, 3] BGR (IMREAD_COLOR) or [H, W] gray
    (IMREAD_GRAYSCALE), equal to `cv2.imread(path, flags)`; None when
    the file cannot be opened (as cv2)."""
    if flags not in (IMREAD_COLOR, IMREAD_GRAYSCALE):
        raise ValueError(f"read_png: flags {flags} (IMREAD_COLOR = 1 and "
                         "IMREAD_GRAYSCALE = 0 only)")
    try:
        data = Path(path).read_bytes()
    except OSError:
        return None
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat, other = None, [], set()
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        else:
            other.add(kind.decode("latin-1"))
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, color, _, _, interlace = header
    if color not in _CHANNELS:
        raise UnsupportedPNG(f"{path}: {_COLOR_NAMES.get(color, color)} "
                             "PNGs are not supported (8-bit gray, gray + "
                             "alpha, RGB and RGBA only)")
    if depth != 8:
        raise UnsupportedPNG(f"{path}: {depth}-bit PNG (8-bit only)")
    if interlace:
        raise UnsupportedPNG(f"{path}: interlaced (Adam7) PNG")
    refused = {"tRNS", "eXIf"}
    if color & 2 and flags == IMREAD_GRAYSCALE:
        # libpng's gray conversion goes through gamma tables when the
        # file carries a gamma
        refused |= {"gAMA", "sRGB", "iCCP"}
    if other & refused:
        raise UnsupportedPNG(f"{path}: PNG with chunk(s) "
                             f"{sorted(other & refused)}")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} bytes of image data for "
                         f"{h}x{w}x{bpp}")
    px = _unfilter(raw.reshape(h, 1 + w * bpp), h, w, bpp)
    if color & 2:                                  # RGB, RGBA
        if flags == IMREAD_COLOR:
            return np.ascontiguousarray(px[..., 2::-1])
        x = px[..., :3].astype(np.int32)
        return ((x[..., 0] * _GRAY_R + x[..., 1] * _GRAY_G
                 + x[..., 2] * _GRAY_B) >> 15).astype(np.uint8)
    gray = px[..., 0]                              # gray, gray + alpha
    if flags == IMREAD_COLOR:
        return np.repeat(gray[..., None], 3, axis=-1)
    return np.ascontiguousarray(gray)


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, image, level=1):
    """Write uint8 [H, W] gray or [H, W, 3] BGR as an 8-bit PNG (every
    row Sub-filtered, zlib `level`) that `cv2.imread` reads back equal."""
    image = np.asarray(image)
    if image.dtype != np.uint8 or not (
            image.ndim == 2 or (image.ndim == 3 and image.shape[2] == 3)):
        raise ValueError(f"write_png: uint8 [H, W] or [H, W, 3] only, got "
                         f"{image.dtype} {image.shape}")
    h, w = image.shape[:2]
    px = image[..., ::-1] if image.ndim == 3 else image[..., None]
    rows = np.empty((h, 1 + px[0].size), np.uint8)
    rows[:, 0] = 1                                 # Sub
    sub = np.diff(px, axis=1, prepend=np.zeros_like(px[:, :1]))
    rows[:, 1:] = sub.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if image.ndim == 3 else 0,
                       0, 0, 0)
    Path(path).write_bytes(
        SIGNATURE + _chunk(b"IHDR", ihdr)
        + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _chunk(b"IEND", b""))
    return True
