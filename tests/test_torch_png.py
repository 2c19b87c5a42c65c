"""The port's PNG reader (slam_framework_torch/io/png.py) against cv2.imread.

A corpus written by cv2.imwrite (smooth and noise images; grey 8/16-bit, RGB and
RGBA at 8 and 16 bits; compression levels 0, 1, 6 and 9) plus grey + alpha
files written here (cv2 cannot write two channels). Tolerance: none.
`imread_gray` equals `cv2.imread(p, cv2.IMREAD_GRAYSCALE)` and `imread_unchanged`
equals `cv2.imread(p, cv2.IMREAD_UNCHANGED)` bit for bit on every file, and the
corpus holds all five filter types (read from the rows' filter bytes). The grey
conversion of colour files is libpng's png_set_rgb_to_gray at OpenCV's weights
(truncated), not cvtColor's rounded formula; a case pins that. Interlaced,
palette and damaged files raise ValueError naming the file; a routine that
cannot be built raises.
"""

import struct
import subprocess
import zlib

import cv2
import numpy as np
import pytest

from slam_framework_torch.io import png

LEVELS = (0, 1, 6, 9)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _write_png(path, rows: np.ndarray, width: int, depth: int, colour: int, interlace: int = 0,
               extra: bytes = b"") -> None:
    """A PNG whose scanlines are stored with filter 0 (rows: (H, row_bytes) uint8)."""
    raw = b"".join(b"\0" + r.tobytes() for r in rows)
    ihdr = struct.pack(">IIBBBBB", width, len(rows), depth, colour, 0, 0, interlace)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + extra
                + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _filter_types(path) -> set:
    with open(path, "rb") as f:
        (w, h, depth, colour, *_), payload = png._read_chunks(str(path), f.read())
    row = w * png._CHANNELS[colour] * depth // 8 + 1
    raw = zlib.decompress(payload)
    return {raw[y * row] for y in range(h)}


def _images(rng):
    yy, xx = np.mgrid[0:96, 0:131]
    smooth = ((np.sin(xx / 9.0) + np.cos(yy / 7.0)) * 60 + 128).astype(np.uint8)
    noise = rng.integers(0, 256, (96, 131), dtype=np.uint8)
    return {
        "gray8_smooth": smooth,
        "gray8_noise": noise,
        "gray16_smooth": smooth.astype(np.uint16) * 257 + (xx % 7).astype(np.uint16),
        "gray16_noise": rng.integers(0, 65536, (96, 131), dtype=np.uint16),
        "bgr8_smooth": np.dstack([smooth, smooth[::-1], smooth[:, ::-1]]),
        "bgr8_noise": rng.integers(0, 256, (96, 131, 3), dtype=np.uint8),
        "bgr16_noise": rng.integers(0, 65536, (96, 131, 3), dtype=np.uint16),
        "bgra8_noise": rng.integers(0, 256, (96, 131, 4), dtype=np.uint8),
        "bgra16_noise": rng.integers(0, 65536, (96, 131, 4), dtype=np.uint16),
    }


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("png")
    rng = np.random.default_rng(0)
    paths = []
    for name, img in _images(rng).items():
        for level in LEVELS:
            p = root / f"{name}_{level}.png"
            assert cv2.imwrite(str(p), img, [cv2.IMWRITE_PNG_COMPRESSION, level])
            paths.append(p)
    for depth in (8, 16):
        ga = rng.integers(0, 2 ** depth, (40, 57, 2)).astype(np.uint8 if depth == 8 else ">u2")
        p = root / f"gray_alpha{depth}.png"
        _write_png(p, ga.reshape(40, -1).view(np.uint8), 57, depth, colour=4)
        paths.append(p)
    return paths


def test_corpus_holds_all_five_filter_types(corpus):
    seen = set()
    for p in corpus:
        seen |= _filter_types(p)
    assert seen == {0, 1, 2, 3, 4}


def test_corpus_covers_the_colour_types_and_depths(corpus):
    kinds = set()
    for p in corpus:
        with open(p, "rb") as f:
            (_, _, depth, colour, *_), _ = png._read_chunks(str(p), f.read())
        kinds.add((colour, depth))
    assert kinds == {(c, d) for c in (0, 2, 4, 6) for d in (8, 16)}


@pytest.mark.parametrize("flag", ["gray", "unchanged"])
def test_reader_equals_cv2_bit_for_bit(corpus, flag):
    read, cv_flag = {"gray": (png.imread_gray, cv2.IMREAD_GRAYSCALE),
                     "unchanged": (png.imread_unchanged, cv2.IMREAD_UNCHANGED)}[flag]
    for p in corpus:
        want = cv2.imread(str(p), cv_flag)
        got = read(str(p))
        assert got.dtype == want.dtype and got.shape == want.shape, p
        np.testing.assert_array_equal(got, want, err_msg=str(p))


def test_colour_to_grey_is_libpng_truncated_not_cvtcolor(tmp_path):
    """cv2 5 reads colour as grey through libpng's png_set_rgb_to_gray(0.299,
    0.587): (9797 R + 19234 G + 3737 B) >> 15, truncated. cvtColor's rounded
    14-bit formula agrees on only about half of random pixels."""
    bgr = np.random.default_rng(1).integers(0, 256, (64, 80, 3), dtype=np.uint8)
    p = str(tmp_path / "rgb.png")
    cv2.imwrite(p, bgr)
    b, g, r = (bgr[..., i].astype(np.int64) for i in range(3))
    libpng = ((9797 * r + 19234 * g + 3737 * b) >> 15).astype(np.uint8)
    np.testing.assert_array_equal(cv2.imread(p, cv2.IMREAD_GRAYSCALE), libpng)
    np.testing.assert_array_equal(png.imread_gray(p), libpng)
    assert (cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY) == libpng).mean() < 0.7


def test_kitti_sized_image_and_multiple_idat_chunks(tmp_path):
    """A 1241x376 grey image, and the same pixels stored across several IDAT chunks."""
    img = cv2.GaussianBlur(np.random.default_rng(2).integers(0, 256, (376, 1241), dtype=np.uint8), (5, 5), 0)
    p = str(tmp_path / "k.png")
    cv2.imwrite(p, img)
    np.testing.assert_array_equal(png.imread_gray(p), img)
    with open(p, "rb") as f:
        data = f.read()
    _, payload = png._read_chunks(p, data)
    ihdr = data[8: 8 + 25]
    parts = [payload[i: i + 997] for i in range(0, len(payload), 997)]
    split = str(tmp_path / "split.png")
    with open(split, "wb") as f:
        f.write(data[:8] + ihdr + b"".join(_chunk(b"IDAT", c) for c in parts) + _chunk(b"IEND", b""))
    assert len(parts) > 3
    np.testing.assert_array_equal(png.imread_gray(split), img)
    np.testing.assert_array_equal(png.imread_unchanged(split), cv2.imread(split, cv2.IMREAD_UNCHANGED))


def test_interlaced_palette_and_damaged_files_raise(tmp_path):
    rows = np.zeros((4, 6), np.uint8)
    interlaced = tmp_path / "adam7.png"
    _write_png(interlaced, rows, 6, 8, colour=0, interlace=1)
    palette = tmp_path / "palette.png"
    _write_png(palette, rows, 6, 8, colour=3, extra=_chunk(b"PLTE", bytes(range(9))))
    four_bit = tmp_path / "gray4.png"
    _write_png(four_bit, rows[:, :3], 6, 4, colour=0)
    for p, what in ((interlaced, "interlaced"), (palette, "palette"), (four_bit, "bit depth 4")):
        with pytest.raises(ValueError, match=what) as e:
            png.imread_gray(str(p))
        assert str(p) in str(e.value)
        with pytest.raises(ValueError, match=what):
            png.imread_unchanged(str(p))
    bad_filter = tmp_path / "filter9.png"
    raw = b"\x09" + bytes(6)
    ihdr = struct.pack(">IIBBBBB", 6, 1, 8, 0, 0, 0, 0)
    bad_filter.write_bytes(b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr) + _chunk(b"IDAT", zlib.compress(raw))
                           + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="filter type"):
        png.imread_gray(str(bad_filter))
    good = tmp_path / "good.png"
    cv2.imwrite(str(good), np.full((5, 5), 7, np.uint8))
    data = bytearray(good.read_bytes())
    data[40] ^= 0xFF   # inside the IDAT chunk: its CRC no longer matches
    damaged = tmp_path / "damaged.png"
    damaged.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="damaged"):
        png.imread_gray(str(damaged))
    for cut in (len(data) - 2, len(data) - 14, 35):   # inside IEND, inside IDAT, inside a chunk header
        truncated = tmp_path / f"truncated{cut}.png"
        truncated.write_bytes(good.read_bytes()[:cut])
        with pytest.raises(ValueError, match="truncated"):
            png.imread_gray(str(truncated))
    not_png = tmp_path / "x.png"
    not_png.write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.imread_gray(str(not_png))
    with pytest.raises(FileNotFoundError):
        png.imread_gray(str(tmp_path / "missing.png"))


def test_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a routine that does not compile raises."""
    bad = tmp_path / "png_unfilter.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(png, "SOURCE", str(bad))
    monkeypatch.setattr(png, "_LIB", None)
    p = tmp_path / "ok.png"
    cv2.imwrite(str(p), np.zeros((3, 3), np.uint8))
    with pytest.raises(subprocess.CalledProcessError):
        png.imread_gray(str(p))
