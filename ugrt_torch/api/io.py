"""Image output: P3 ASCII PPM matching the reference writer, its reader,
plus PNG (the port's copy of ugrt/api/io.py).

writePPM (per_app_funcs.h:39-66) emits "P3\\n<w> <h>\\n255" then one
leading newline per pixel row and space-separated values.  The reference
then shells out to ImageMagick for JPG + vertical flip (main.cu:244-259);
here ``flip=True`` flips in-process.  ``write_ppm`` takes the native
writer (``scene.native``) where a C++ compiler exists: the same bytes as
the Python writer.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def write_ppm(path: str, image_u8, flip: bool = False) -> None:
    """Write [H, W, 3] u8 as P3 ASCII PPM (per_app_funcs.h:39-66).

    Uses the native writer (native/ugrt_native.cpp) when a C++ compiler
    exists; byte-identical output either way."""
    from ugrt_torch.scene import native

    if native.available():
        native.write_ppm_fast(path, np.asarray(image_u8, dtype=np.uint8),
                              flip=flip)
        return
    img = np.asarray(image_u8, dtype=np.uint8)
    if flip:
        img = img[::-1]
    h, w, _ = img.shape
    flat = img.reshape(h, w * 3)
    with open(path, "w") as fp:
        fp.write("P3\n")
        fp.write(f"{w} {h}\n")
        fp.write("255\n")
        for row in flat:
            fp.write("\n")
            fp.write(" ".join(str(int(v)) for v in row))
            fp.write(" ")
        fp.write("\n")


def read_ppm(path: str) -> np.ndarray:
    """Read a P3 PPM back into [H, W, 3] u8."""
    with open(path, "r") as fp:
        tokens = fp.read().split()
    if tokens[0] != "P3":
        raise ValueError(f"{path}: not a P3 PPM")
    w, h = int(tokens[1]), int(tokens[2])
    data = np.asarray([int(t) for t in tokens[4:4 + w * h * 3]],
                      dtype=np.uint8)
    return data.reshape(h, w, 3)


def write_png(path: str, image_u8, flip: bool = False) -> None:
    """Write PNG without external deps (pure-python zlib encoder)."""
    img = np.asarray(image_u8, dtype=np.uint8)
    if flip:
        img = img[::-1]
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fp:
        fp.write(b"\x89PNG\r\n\x1a\n")
        fp.write(chunk(b"IHDR", header))
        fp.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fp.write(chunk(b"IEND", b""))
