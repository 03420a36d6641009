"""PFM / PPM image I/O, host-side.

Byte-compatible with the reference writer/reader
(``Image/Image.cpp:14-128``): PFM "PF" header, bottom-up
scanline order, byte-order field (-1 little endian), float32 RGB triples.
PPM is ASCII P3 with sRGB encoding.
"""

from __future__ import annotations

import numpy as np

__all__ = ["write_pfm", "read_pfm", "write_ppm", "write_image", "read_image"]


def write_pfm(path, img: np.ndarray) -> None:
    """img: [H, W, 3] float32, row 0 = top (we store top-down; PFM stores
    bottom-up, matching Image.cpp:40-56 where j runs ny-1..0 and the
    reference's Image row 0 is the bottom row — the reference's raster row y
    counts from the top via the camera transform, and image(x, y) uses y as
    stored; write_pfm emits rows ny-1..0).

    We adopt the convention: our img row 0 = raster row 0 = TOP of the
    picture (camera pixel y=0).  The reference's ``Image`` row 0 is raster
    row 0 too, and its writer emits row ny-1 first.  So we emit img rows
    H-1..0 — identical bytes for identical content.
    """
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(b"PF\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")
        flipped = img[::-1]  # bottom row first
        f.write(flipped.astype("<f4").tobytes())


def read_pfm(path) -> np.ndarray:
    """Returns [H, W, 3] float32 with row 0 = top (inverse of write_pfm)."""
    with open(path, "rb") as f:
        header = f.readline().strip()
        if header != b"PF":
            raise ValueError(f"Unexpected PFM format: {header!r}")
        dims = f.readline().split()
        w, h = int(dims[0]), int(dims[1])
        scale = float(f.readline().strip())
        dtype = "<f4" if scale < 0 else ">f4"
        data = np.frombuffer(f.read(w * h * 3 * 4), dtype=dtype)
        img = data.reshape(h, w, 3).astype(np.float32)
        return img[::-1]


def _srgb(u: np.ndarray) -> np.ndarray:
    return np.where(u <= 0.0031308, 12.92 * u,
                    1.055 * np.power(np.maximum(u, 1e-12), 1.0 / 2.4) - 0.055)


def write_ppm(path, img: np.ndarray) -> None:
    """ASCII P3, sRGB-encoded (Image.cpp:14-38)."""
    img = np.asarray(img, dtype=np.float32)
    h, w, _ = img.shape
    with open(path, "w") as f:
        f.write(f"P3\n{w} {h}\n255\n")
        for row in img[::-1]:
            for px in row:
                c = _srgb(px)
                f.write(f"{int(255.99 * c[0])} {int(255.99 * c[1])} {int(255.99 * c[2])}\n")


def write_image(path, img: np.ndarray) -> None:
    path = str(path)
    if path.endswith(".pfm"):
        write_pfm(path, img)
    elif path.endswith(".ppm"):
        write_ppm(path, img)
    else:
        raise ValueError(f"Unknown image extension: {path}")


def read_image(path) -> np.ndarray:
    path = str(path)
    if path.endswith(".pfm"):
        return read_pfm(path)
    raise ValueError(f"Unknown image extension: {path}")
