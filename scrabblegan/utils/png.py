"""PNG and animated-PNG (APNG) encoding and PNG decoding with numpy and zlib.

Writes 8-bit grayscale or RGB images with no row filter, and reads back PNGs
of that kind; any other PNG raises `UnsupportedPNG`, so a caller can hand it
to another decoder (data/images.py falls back to cv2 or PIL).
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}  # PNG colour type -> samples per pixel


class UnsupportedPNG(ValueError):
    pass


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _as_uint8(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[-1] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3), got {img.shape}")
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def _ihdr(img: np.ndarray) -> bytes:
    h, w = img.shape[:2]
    return _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                       0 if img.ndim == 2 else 2, 0, 0, 0))


def _compressed_rows(img: np.ndarray) -> bytes:
    rows = img.reshape(img.shape[0], -1)
    raw = np.concatenate([np.zeros((rows.shape[0], 1), np.uint8), rows], axis=1)
    return zlib.compress(raw.tobytes(), 6)  # filter type 0 on every row


def encode_png(img: np.ndarray) -> bytes:
    img = _as_uint8(img)
    return (_SIGNATURE + _ihdr(img) + _chunk(b"IDAT", _compressed_rows(img))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))


def write_apng(path: str, frames: Sequence[np.ndarray], delay_ms: int = 500) -> None:
    """An endlessly looping animation of same-shaped frames."""
    frames = [_as_uint8(f) for f in frames]
    if not frames or any(f.shape != frames[0].shape for f in frames):
        raise ValueError("write_apng needs one or more frames of one shape")
    h, w = frames[0].shape[:2]
    out = [_SIGNATURE, _ihdr(frames[0]),
           _chunk(b"acTL", struct.pack(">II", len(frames), 0))]
    seq = 0  # fcTL and fdAT chunks share one sequence counter
    for i, f in enumerate(frames):
        out.append(_chunk(b"fcTL", struct.pack(">IIIIIHHBB", seq, w, h, 0, 0,
                                               delay_ms, 1000, 0, 0)))
        seq += 1
        if i == 0:
            out.append(_chunk(b"IDAT", _compressed_rows(f)))
        else:
            out.append(_chunk(b"fdAT", struct.pack(">I", seq) + _compressed_rows(f)))
            seq += 1
    out.append(_chunk(b"IEND", b""))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))


def read_png(path: str) -> np.ndarray:
    """(H, W) uint8 for grayscale, (H, W, 3) for RGB."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise UnsupportedPNG("not a PNG file")
    pos, idat, header = len(_SIGNATURE), [], None
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise UnsupportedPNG("no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise UnsupportedPNG(f"unsupported PNG (depth {depth}, colour type "
                             f"{ctype}, interlace {interlace})")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise UnsupportedPNG(f"corrupt image data: {e}") from e
    if len(raw) != h * (w * ch + 1):
        raise UnsupportedPNG("image data does not match the header")
    rows = np.frombuffer(raw, np.uint8).reshape(h, w * ch + 1)
    if rows[:, 0].any():
        raise UnsupportedPNG("row filters other than None are not decoded here")
    img = rows[:, 1:]
    return img.reshape(h, w) if ch == 1 else img.reshape(h, w, ch)
