"""PNG files in numpy and zlib, so that reading and writing images needs
neither OpenCV nor PIL on the machine with the card.

`read_png` decodes what `cv2.imread(path, cv2.IMREAD_COLOR)` followed by
BGR -> RGB gives, for non-interlaced files: 8-bit gray, gray + alpha, RGB and
RGBA, the same at 16 bits (the high byte kept, as OpenCV does), and palette
images at 1, 2, 4 or 8 bits. Alpha and transparency are dropped and gray is
repeated into three channels, as OpenCV does for a colour read. Anything else
raises a ValueError naming the file and what it does not support.
`write_png` writes uint8 gray (H, W) and RGB (H, W, 3) images.
tests/test_torch_host_io.py holds both against cv2.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel (0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data, path):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length  # length, type, body, CRC


def _unfilter(raw, height, rowbytes, bpp, path):
    """The reconstructed bytes (height, rowbytes) of the filtered scanlines
    `raw` (each a filter-type byte and `rowbytes` bytes); `bpp` is the
    filter's byte distance to the left neighbour (at least 1)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (rowbytes + 1):
        raise ValueError(f"{path}: image data holds {rows.size} bytes, expected "
                         f"{height * (rowbytes + 1)}")
    rows = rows.reshape(height, rowbytes + 1)
    ftype, filt = rows[:, 0], rows[:, 1:]
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {int(ftype.max())}")
    if not ftype.any():
        return filt.copy()
    # Sub, Average and Paeth read the reconstructed left neighbour, Up and
    # the last two the row above: bytes on one anti-diagonal of the
    # (row, pixel) grid depend only on earlier diagonals, so each diagonal is
    # one vector step. rec has a zero row above and zero pixels to the left.
    npx = rowbytes // bpp
    f = filt.reshape(height, npx, bpp).astype(np.int32)
    rec = np.zeros((height + 1, npx + 1, bpp), np.int32)
    for d in range(height + npx - 1):
        y = np.arange(max(0, d - npx + 1), min(height, d + 1))
        x = d - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.choose(ftype[y][:, None], (np.zeros_like(a), a, b, (a + b) >> 1, paeth))
        rec[y + 1, x + 1] = (f[y, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8).reshape(height, rowbytes)


def read_png(path):
    """The image in `path` as RGB uint8 (H, W, 3), as cv2.imread with
    IMREAD_COLOR and a BGR -> RGB swap give it."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unsupported PNG colour type {ctype}")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if depth not in ((1, 2, 4, 8) if ctype == 3 else (8, 16)):
        raise ValueError(f"{path}: unsupported PNG bit depth {depth} for colour type "
                         f"{ctype}")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    rowbytes = (width * ch * depth + 7) // 8
    rows = _unfilter(zlib.decompress(b"".join(idat)), height, rowbytes,
                     max(1, ch * depth // 8), path)
    if ctype == 3:
        idx = np.unpackbits(rows, axis=1)[:, :width * depth] if depth < 8 else rows
        if depth < 8:
            idx = idx.reshape(height, width, depth) @ (1 << np.arange(depth - 1, -1, -1))
        if idx.max(initial=0) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the PLTE chunk")
        return palette[idx]
    # 16-bit samples are big-endian: the high byte is the first
    px = rows.reshape(height, width, ch, depth // 8)[..., 0]
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path, img):
    """Write a uint8 gray (H, W) or RGB (H, W, 3) image as an 8-bit PNG
    (rows unfiltered, zlib level 6)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png: needs uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, 1 + w * (img.size // (h * w))), np.uint8)  # filter byte 0
    rows[:, 1:] = img.reshape(h, -1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if img.ndim == 2 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))
