"""`io/png.py`, the port's PNG reader and writer, against OpenCV.

* `read_png` equals `cv2.imread` bitwise (tolerance 0) on PNGs that
  `cv2.imwrite` writes at compression 0-9 (Sub, Up and Paeth rows): gray,
  BGR and BGRA, read as color and as gray; on files whose rows cycle
  through all five scanline filters; on a gray + alpha file and a
  384x512 frame.
* `cv2.imread` reads `write_png`'s gray and BGR files back equal to what
  was written (tolerance 0).
* 16-bit, palette and interlaced PNGs raise ValueError naming what they
  are; a missing file gives None, as cv2.
* `io/stream.py` reads PNG frames and masks with cv2 blocked, equal to
  the frames cv2 reads.
"""

import struct
import sys
import zlib

import numpy as np
import pytest

from wild_video_3d_reconstruction_torch.io import png
from wild_video_3d_reconstruction_torch.io import stream as tstream

cv2 = pytest.importorskip("cv2")


def _images(rng, h=37, w=53):
    """A smooth gradient with noise (adaptive filtering picks Sub, Up,
    Average and Paeth rows on it) and pure noise."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([xx * 3 + yy, yy * 5, (xx * yy) % 256], -1) % 256
    noisy = np.clip(base + rng.integers(-20, 20, base.shape), 0, 255)
    noisy = noisy.astype(np.uint8)
    alpha = rng.integers(0, 256, (h, w, 1), dtype=np.uint8)
    return {"bgr": noisy, "gray": noisy[..., 0],
            "bgra": np.concatenate([noisy, alpha], -1),
            "noise": rng.integers(0, 256, (h, w, 3), dtype=np.uint8)}


def _filter_types(path):
    """The scanline filter types of an 8-bit PNG written by cv2."""
    data = open(path, "rb").read()
    header, idat = None, []
    for kind, body in png._chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    w, h, _, color = header[:4]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    return set(raw.reshape(h, -1)[:, 0].tolist())


@pytest.mark.parametrize("name", ["bgr", "gray", "bgra", "noise"])
def test_read_png_equals_cv2_imread_at_every_compression(name, tmp_path):
    img = _images(np.random.default_rng(0))[name]
    seen = set()
    for level in range(10):
        path = tmp_path / f"{level}.png"
        assert cv2.imwrite(str(path), img,
                           [cv2.IMWRITE_PNG_COMPRESSION, level])
        seen |= _filter_types(path)
        for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
            ref = cv2.imread(str(path), flags)
            out = png.read_png(path, flags)
            assert out.dtype == ref.dtype and out.shape == ref.shape
            np.testing.assert_array_equal(out, ref)
    if name != "gray":
        assert {1, 2, 4} <= seen, seen


def _filtered(px, types):
    """PNG scanlines of px [h, w, bpp] uint8, row r filtered with
    types[r] (the encoder side of the five filters, written out)."""
    h, w, bpp = px.shape
    x = px.astype(np.int64).reshape(h, w * bpp)
    rows = np.zeros((h, 1 + w * bpp), np.uint8)
    for r in range(h):
        up = x[r - 1] if r else np.zeros(w * bpp, np.int64)
        for i in range(w * bpp):
            a = x[r, i - bpp] if i >= bpp else 0
            b = up[i]
            c = up[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[types[r]]
            rows[r, 1 + i] = (x[r, i] - pred) % 256
        rows[r, 0] = types[r]
    return rows


@pytest.mark.parametrize("color", [0, 2, 6])
def test_read_png_equals_cv2_imread_on_all_five_filters(color, tmp_path):
    rng = np.random.default_rng(4)
    bpp = {0: 1, 2: 3, 6: 4}[color]
    px = rng.integers(0, 256, (15, 13, bpp), dtype=np.uint8)
    px[5:] = np.clip(px[5:] // 3 + np.arange(13)[:, None] * 9, 0, 255)
    types = [r % 5 for r in range(15)]
    ihdr = struct.pack(">IIBBBBB", 13, 15, 8, color, 0, 0, 0)
    path = tmp_path / "f.png"
    path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                     + png._chunk(b"IDAT", zlib.compress(
                         _filtered(px, types).tobytes()))
                     + png._chunk(b"IEND", b""))
    assert _filter_types(path) == {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED).reshape(px.shape)[
            ..., [2, 1, 0, 3][:bpp] if bpp > 1 else [0]], px)
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        np.testing.assert_array_equal(png.read_png(path, flags),
                                      cv2.imread(str(path), flags))


def test_read_png_gray_alpha_and_full_frame(tmp_path):
    rng = np.random.default_rng(1)
    la = rng.integers(0, 256, (9, 11, 2), dtype=np.uint8)
    rows = np.concatenate([np.zeros((9, 1), np.uint8), la.reshape(9, -1)], 1)
    path = tmp_path / "la.png"
    path.write_bytes(
        png.SIGNATURE
        + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 11, 9, 8, 4, 0, 0, 0))
        + png._chunk(b"IDAT", zlib.compress(rows.tobytes()))
        + png._chunk(b"IEND", b""))
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        np.testing.assert_array_equal(png.read_png(path, flags),
                                      cv2.imread(str(path), flags))
    frame = rng.integers(0, 256, (384, 512, 3), dtype=np.uint8)
    cv2.imwrite(str(tmp_path / "f.png"), frame)
    np.testing.assert_array_equal(png.read_png(tmp_path / "f.png"), frame)


@pytest.mark.parametrize("name", ["bgr", "gray", "noise"])
def test_cv2_reads_write_png_back_equal(name, tmp_path):
    img = _images(np.random.default_rng(2))[name]
    path = tmp_path / "w.png"
    png.write_png(path, img)
    np.testing.assert_array_equal(
        cv2.imread(str(path), cv2.IMREAD_UNCHANGED), img)
    for flags in (cv2.IMREAD_COLOR, cv2.IMREAD_GRAYSCALE):
        np.testing.assert_array_equal(png.read_png(path, flags),
                                      cv2.imread(str(path), flags))


def test_unsupported_pngs_raise_and_missing_gives_none(tmp_path):
    cv2.imwrite(str(tmp_path / "16.png"), np.zeros((4, 5), np.uint16))
    with pytest.raises(ValueError, match="16-bit"):
        png.read_png(tmp_path / "16.png")

    def raw_png(path, color, interlace, extra=b""):
        ihdr = struct.pack(">IIBBBBB", 2, 2, 8, color, 0, 0, interlace)
        path.write_bytes(png.SIGNATURE + png._chunk(b"IHDR", ihdr) + extra
                         + png._chunk(b"IDAT", zlib.compress(bytes(10)))
                         + png._chunk(b"IEND", b""))
        return path

    with pytest.raises(ValueError, match="palette"):
        png.read_png(raw_png(tmp_path / "p.png", 3, 0,
                             png._chunk(b"PLTE", bytes(3))))
    with pytest.raises(ValueError, match="interlaced"):
        png.read_png(raw_png(tmp_path / "i.png", 0, 1))
    with pytest.raises(ValueError, match="not a PNG"):
        (tmp_path / "x.png").write_bytes(b"GIF89a")
        png.read_png(tmp_path / "x.png")
    with pytest.raises(ValueError):
        png.write_png(tmp_path / "f.png", np.zeros((4, 4), np.float32))
    assert png.read_png(tmp_path / "missing.png") is None
    assert cv2.imread(str(tmp_path / "missing.png")) is None


def test_stream_reads_png_frames_and_masks_without_cv2(tmp_path,
                                                       monkeypatch):
    rng = np.random.default_rng(3)
    for d in ("rgb", "mask"):
        (tmp_path / d).mkdir()
    images = rng.integers(0, 256, (3, 40, 70, 3), dtype=np.uint8)
    masks = rng.integers(0, 2, (3, 40, 70), dtype=np.uint8) * 255
    for t in range(3):
        cv2.imwrite(str(tmp_path / "rgb" / f"{t:03d}.png"), images[t])
        png.write_png(tmp_path / "mask" / f"{t:03d}.png", masks[t])
    monkeypatch.setitem(sys.modules, "cv2", None)     # import raises
    out = list(tstream.image_frames(tmp_path / "rgb", None,
                                    tmp_path / "mask", [40.0, 40, 35, 20]))
    assert len(out) == 3
    for t, image, depth, mask, intr in out:
        np.testing.assert_array_equal(image, images[t][:32, :64])
        np.testing.assert_array_equal(mask, masks[t][:32, :64] > 0)
        assert depth is None and intr.tolist() == [40.0, 40, 35, 20]
