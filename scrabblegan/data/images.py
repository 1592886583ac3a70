"""Host-side image IO helpers.

The reference depends on OpenCV for all image work (imread grayscale, resize,
imwrite — iam_handwriting_db.py, data_utils.py). Here PNGs — everything this
package writes, the synthetic dataset included — are read and written by the
numpy/zlib codec in utils/png.py, so training on the synthetic dataset needs
neither cv2 nor PIL. Those stay optional: they decode what that codec does not
(other formats and encoders, colour scans) and do the resampling that real
IAM/RIMES scans need.
"""

from __future__ import annotations

import numpy as np

from scrabblegan.utils import png

try:
    import cv2

    _HAS_CV2 = True
except ImportError:  # pragma: no cover
    _HAS_CV2 = False

try:
    from PIL import Image

    _HAS_PIL = True
except ImportError:  # pragma: no cover
    _HAS_PIL = False


def read_grayscale(path: str) -> np.ndarray | None:
    """Read an image as uint8 grayscale (H, W); None on failure."""
    try:
        img = png.read_png(str(path))
        if img.ndim == 2:
            return img
    except (OSError, png.UnsupportedPNG):
        pass  # not a PNG this codec reads: try cv2 / PIL
    if _HAS_CV2:
        return cv2.imread(str(path), cv2.IMREAD_GRAYSCALE)
    if _HAS_PIL:
        try:
            return np.asarray(Image.open(path).convert("L"))
        except OSError:
            return None
    return None


def resize(img: np.ndarray, width: int, height: int, quality: str = "area") -> np.ndarray:
    """Resize (H, W) uint8/float to (height, width)."""
    if img.shape[:2] == (height, width):
        return img.copy()
    if _HAS_CV2:
        interp = {
            "area": cv2.INTER_AREA,
            "cubic": cv2.INTER_CUBIC,
            "linear": cv2.INTER_LINEAR,
        }[quality]
        return cv2.resize(img, (width, height), interpolation=interp)
    if _HAS_PIL:
        mode_img = Image.fromarray(img.astype(np.uint8))
        resample = {"area": Image.BOX, "cubic": Image.BICUBIC, "linear": Image.BILINEAR}[quality]
        return np.asarray(mode_img.resize((width, height), resample=resample))
    raise RuntimeError("resizing needs cv2 or PIL")


def write_grayscale(path: str, img: np.ndarray) -> None:
    """Write (H, W) values in [0, 255] as an 8-bit grayscale PNG."""
    png.write_png(str(path), np.clip(img, 0, 255).astype(np.uint8))
