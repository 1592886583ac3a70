"""Visual evaluation: fixed-seed sample grids per epoch and the training animation.

Capability parity with generate_and_save_images / make_gif (data_utils.py:493-547):
a 4x4 grid of generator samples on a FIXED (style image, label) seed, saved as
image_at_epoch_%04d.png, and an animation over the saved grids with the
reference's sqrt-spaced frame schedule. Both are written as PNG / animated PNG
by utils/png.py (numpy + zlib), without the reference's text captions.
"""

from __future__ import annotations

import glob
import os

import numpy as np

from scrabblegan.utils.png import read_png, write_apng, write_png

_GUTTER = 4  # white pixels between tiles


def image_grid(images: np.ndarray, grid: tuple = (4, 4)) -> np.ndarray:
    """(N, H, W[, 1]) in [-1, 1] -> one uint8 (rows*H, cols*W) mosaic,
    row-major, white gutters; missing tiles stay white."""
    images = np.asarray(images, np.float32)
    if images.ndim == 4:
        images = images[..., 0]
    tiles = np.clip((images + 1.0) * 127.5, 0, 255).astype(np.uint8)
    rows, cols = grid
    n, h, w = tiles.shape
    out = np.full((rows * (h + _GUTTER) + _GUTTER, cols * (w + _GUTTER) + _GUTTER),
                  255, np.uint8)
    for i in range(min(n, rows * cols)):
        r, c = divmod(i, cols)
        y, x = _GUTTER + r * (h + _GUTTER), _GUTTER + c * (w + _GUTTER)
        out[y:y + h, x:x + w] = tiles[i]
    return out


def save_image_grid(images: np.ndarray, out_path: str, grid: tuple = (4, 4)) -> None:
    """images: (N, H, W) or (N, H, W, 1) in [-1, 1]."""
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    write_png(out_path, image_grid(images, grid))


def save_epoch_grid(images, gen_path: str, epoch: int) -> str:
    out = os.path.join(gen_path, f"image_at_epoch_{epoch:04d}.png")
    save_image_grid(images, out)
    return out


def make_animation(gen_path: str, out_name: str = "training.png") -> str | None:
    """sqrt-spaced frame schedule over image_at_epoch_*.png (data_utils.py:522-547),
    written as an animated PNG."""
    filenames = sorted(glob.glob(os.path.join(gen_path, "image_at_epoch_*.png")))
    if not filenames:
        return None
    frames, last = [], -1.0
    for i, filename in enumerate(filenames):
        frame = 2 * (i ** 0.5)
        if round(frame) > round(last):
            last = frame
            frames.append(read_png(filename))
    frames.append(read_png(filenames[-1]))
    anim_file = os.path.join(gen_path, out_name)
    write_apng(anim_file, frames)
    return anim_file
