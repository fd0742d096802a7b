"""Shared PIL-based helpers for the 2D RGB-D preprocessors (a copy of
``openscene_tpu.preprocess.images_2d``).

The reference scripts use imageio + cv2, which the package does not depend
on; PIL covers the same operations: jpeg/png IO, nearest/bilinear resize,
uint16 depth PNGs.  PIL is imported inside each function, so the package
imports without it; these helpers, and the preprocessors that call them,
run on a host that has it.
"""

from __future__ import annotations

import numpy as np


def load_image(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def resize_color(img: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    """size = (width, height); nearest matches cv2.INTER_NEAREST, else
    bilinear (cv2's default INTER_LINEAR)."""
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(img).resize(size, mode))


def save_color(path: str, img: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(img).save(path)


def load_depth_u16(path: str) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.uint16)


def resize_depth_u16(depth: np.ndarray, size, nearest: bool = True) -> np.ndarray:
    """uint16 depth resize. Nearest by default (interpolating depth across
    object boundaries fabricates geometry); the replica reference script uses
    linear (cv2.INTER_LINEAR) — pass nearest=False there for parity."""
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BILINEAR
    im = Image.fromarray(depth.astype(np.int32), mode="I")
    out = np.asarray(im.resize(size, mode))
    return np.clip(out, 0, 65535).astype(np.uint16)


def save_depth_u16(path: str, depth: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(depth.astype(np.uint16)).save(path)


def read_lines(path: str):
    with open(path) as f:
        return [ln.rstrip() for ln in f if ln.strip()]
