"""PNG codec in numpy and the standard library's zlib: the plain version of
the native decoder (``native/loader.cpp``).

Decoding covers the subset the native decoder handles: 8-bit gray, RGB and
RGBA, 16-bit big-endian gray (and RGB/RGBA, which the frame conversions
then reject), non-interlaced, all five filter types. It applies the same
checks in the same places and the same float conversions, so for any file
both decoders give identical arrays or both fail. ``png_size``,
``decode_intensity`` and ``decode_depth`` have the native module's
signatures; utils/tum.py picks one of the two by name.

Encoding writes 8-bit and 16-bit grayscale, what a TUM RGB-D directory
stores, with the Up filter on every row.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # color type -> channels
_MAX_SIDE = 1 << 15  # decoder: any camera frame, no size_t overflow
_MAX_RAW = 1 << 30  # decoder: bytes of inflated scanlines
_PROBE_SIDE = 1 << 20  # png_size: dimension caps of the header probe
_PROBE_PIXELS = 1 << 30
_ZLIB_LEVEL = 1  # fastest: the frames are written once, read many times


def _be32(data, pos):
    return struct.unpack_from(">I", data, pos)[0]


def _read(path):
    with open(path, "rb") as f:
        return f.read()


def _unfilter(raw, height, stride, bpp):
    """Undo the per-row filters of the inflated scanlines: (height,
    stride) uint8. A pixel depends on its left, upper and upper-left
    neighbours only, so all pixels of one anti-diagonal (y + x constant,
    in pixels) are decoded together: height + width - 1 vector steps."""
    rows = raw.reshape(height, stride + 1)
    ftype = rows[:, 0].astype(np.int16)
    if (ftype > 4).any():
        raise OSError("bad filter byte")
    width = stride // bpp
    src = rows[:, 1:].reshape(height, width, bpp).astype(np.int16)
    # One row and one column of zeros in front: the left / upper
    # neighbours outside the image are 0.
    out = np.zeros((height + 1, width + 1, bpp), np.int16)
    for d in range(height + width - 1):
        y = np.arange(max(0, d - width + 1), min(height, d + 1))
        x = d - y
        a = out[y + 1, x]  # left
        b = out[y, x + 1]  # up
        c = out[y, x]  # up-left
        f = ftype[y][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        out[y + 1, x + 1] = (src[y, x] + pred) & 0xFF
    return out[1:, 1:].astype(np.uint8).reshape(height, stride)


def decode(data: bytes) -> np.ndarray:
    """Decode a PNG held in memory: (H, W, C) uint8 for 8-bit files,
    uint16 for 16-bit ones. Raises OSError on what the native decoder
    rejects."""
    if len(data) < 8 or data[:8] != _MAGIC:
        raise OSError("not a png")
    pos = 8
    idat = []
    width = height = 0
    bit_depth = color_type = interlace = -1
    while pos + 8 <= len(data):
        length = _be32(data, pos)
        if pos + 12 + length > len(data):
            break
        ctype = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + length]
        if ctype == b"IHDR":
            if length < 13:
                raise OSError("truncated IHDR")
            # The header's dimensions as the C decoder's int sees them.
            width, height = (v - (1 << 32) if v >= 1 << 31 else v
                             for v in struct.unpack_from(">II", payload))
            bit_depth, color_type = payload[8], payload[9]
            interlace = payload[12]
        elif ctype == b"IDAT":
            idat.append(payload)
        elif ctype == b"IEND":
            break
        pos += 12 + length
    if width <= 0 or height <= 0:
        raise OSError("bad IHDR")
    if width > _MAX_SIDE or height > _MAX_SIDE:
        raise OSError("implausible dimensions")
    if interlace != 0:
        raise OSError("interlaced png unsupported")
    if color_type not in _CHANNELS:
        raise OSError(f"unsupported color type {color_type}")
    if bit_depth not in (8, 16):
        raise OSError("unsupported bit depth")
    channels = _CHANNELS[color_type]
    bpp = channels * bit_depth // 8
    stride = width * bpp
    raw_size = (stride + 1) * height
    if raw_size > _MAX_RAW:
        raise OSError("implausible image size")
    # The native decoder inflates into a zeroed buffer of exactly raw_size
    # bytes and needs the stream's end: a short stream leaves zeros, a
    # long one or a broken one fails.
    inflater = zlib.decompressobj()
    try:
        raw = inflater.decompress(b"".join(idat), raw_size)
        # A full buffer may stop short of the stream's end marker: go on
        # until the end, failing on any byte past raw_size.
        if not inflater.eof and len(raw) == raw_size:
            if inflater.decompress(inflater.unconsumed_tail, 1):
                raise OSError("inflate failed")
    except zlib.error as e:
        raise OSError(f"inflate failed: {e}") from None
    if not inflater.eof:
        raise OSError("inflate failed")
    raw = np.frombuffer(raw.ljust(raw_size, b"\0"), np.uint8)
    img = _unfilter(raw, height, stride, bpp)
    if bit_depth == 16:
        img = img.view(">u2").astype(np.uint16)
    return img.reshape(height, width, channels)


def png_size(path: str):
    """(width, height) from the header, with the native probe's checks."""
    data = _read(path)
    if (len(data) < 33 or data[:8] != _MAGIC
            or data[12:16] != b"IHDR"):
        raise OSError(f"cannot probe {path}")
    w, h = struct.unpack_from(">II", data, 16)
    if not (0 < w <= _PROBE_SIDE and 0 < h <= _PROBE_SIDE
            and w * h <= _PROBE_PIXELS):
        raise OSError(f"cannot probe {path}")
    return w, h


def _decode_file(path, width, height):
    try:
        img = decode(_read(path))
    except OSError as e:
        raise OSError(f"decode failed: {path}: {e}") from None
    if img.shape[:2] != (height, width):
        raise OSError(f"decode failed: {path}: unexpected size")
    return img


def decode_intensity(path: str, width: int, height: int) -> np.ndarray:
    """An 8-bit gray/RGB/RGBA file as float32 intensity 0..255 (H, W):
    0.299 R + 0.587 G + 0.114 B, each product and sum rounded to float32
    in that order, as the native decoder computes it."""
    img = _decode_file(path, width, height)
    if img.dtype != np.uint8:
        raise OSError(f"decode failed: {path}: rgb must be 8-bit")
    if img.shape[2] == 1:
        return img[..., 0].astype(np.float32)
    px = img.astype(np.float32)
    return (np.float32(0.299) * px[..., 0] + np.float32(0.587) * px[..., 1]
            + np.float32(0.114) * px[..., 2])


def decode_depth(path: str, width: int, height: int,
                 scale: float = 5000.0) -> np.ndarray:
    """A 16-bit gray file as float32 meters (H, W): raw * (1 / scale) in
    float32, raw 0 -> NaN."""
    img = _decode_file(path, width, height)
    if img.dtype != np.uint16 or img.shape[2] != 1:
        raise OSError(f"decode failed: {path}: depth must be 16-bit "
                      "grayscale")
    raw = img[..., 0].astype(np.float32)
    inv = np.float32(1.0) / np.float32(scale)
    return np.where(raw != 0, raw * inv, np.float32(np.nan))


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode(image: np.ndarray) -> bytes:
    """A 2-D uint8 or uint16 array as a grayscale PNG (8 or 16 bits),
    every row Up-filtered."""
    image = np.asarray(image)
    if image.ndim != 2 or image.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"want a 2-D uint8 or uint16 image, got "
                         f"{image.dtype} {image.shape}")
    height, width = image.shape
    bit_depth = 8 * image.dtype.itemsize
    rows = image.astype(image.dtype.newbyteorder(">")).view(np.uint8)
    rows = rows.reshape(height, width * image.dtype.itemsize)
    up = rows.copy()
    up[1:] -= rows[:-1]  # uint8 wraps mod 256, as the filter wants
    scan = np.concatenate([np.full((height, 1), 2, np.uint8), up], axis=1)
    ihdr = struct.pack(">IIBBBBB", width, height, bit_depth, 0, 0, 0, 0)
    return (_MAGIC + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(scan.tobytes(), _ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write(path: str, image: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode(image))
