"""A PNG encoder on zlib and struct alone.

The JAX package writes its debug images and the viewer's depth pane
through cv2 or PIL. The port writes every PNG here instead, so that its
images need neither (the machine that runs the card may have neither):
8-bit RGB or grayscale, one IDAT chunk, filter type 0 (none) on every
row, zlib level 1 by default (cv2's default PNG level: the images are
written on the frame's path, and level 6 costs several times more for
a little less size). Any PNG decoder reads the pixels back exactly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray, level: int = 1) -> bytes:
    """[H, W, 3] (RGB) or [H, W] (gray) uint8 pixels as PNG bytes."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (
            img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"encode_png takes [H, W] or [H, W, 3] uint8, got "
                         f"{img.dtype} {img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
