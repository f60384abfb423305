"""Image file ⇄ CHW float tensors (reference: rten-imageio/src/lib.rs): a
numpy copy of ``rten_tpu/image/io.py``, so that the port's vision models
take images without the JAX package. PIL is imported only by
``read_image`` / ``write_image``."""

from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def read_image(path: str) -> np.ndarray:
    """Load an image file as CHW float32 in [0, 1] (reference: read_image)."""
    from PIL import Image

    with Image.open(path) as im:
        arr = np.asarray(im.convert("RGB"), dtype=np.float32) / 255.0
    return hwc_to_chw(arr)


def write_image(path: str, chw: np.ndarray) -> None:
    """Save a CHW float tensor in [0, 1] to an image file."""
    from PIL import Image

    hwc = chw_to_hwc(np.asarray(chw))
    data = np.clip(hwc * 255.0 + 0.5, 0, 255).astype(np.uint8)
    if data.shape[-1] == 1:
        data = data[..., 0]
    Image.fromarray(data).save(path)


def hwc_to_chw(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        img = img[:, :, None]
    return np.ascontiguousarray(np.transpose(img, (2, 0, 1)))


def chw_to_hwc(img: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(img, (1, 2, 0)))


def normalize_image(
    chw: np.ndarray,
    mean: np.ndarray = IMAGENET_MEAN,
    std: np.ndarray = IMAGENET_STD,
) -> np.ndarray:
    """Per-channel (x - mean) / std (reference: normalize_image,
    rten-imageio/src/lib.rs:26)."""
    chw = np.asarray(chw, dtype=np.float32)
    return (chw - mean[:, None, None]) / std[:, None, None]
