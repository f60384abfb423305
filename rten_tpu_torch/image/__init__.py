"""Image pre- and post-processing: ``io`` (a copy of ``rten_tpu/image/io``:
image file ⇄ CHW float tensor, ImageNet normalization). The rest of
``rten_tpu/image`` (shapes, contours, polygons, drawing) is not ported."""

from rten_tpu_torch.image.io import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    chw_to_hwc,
    hwc_to_chw,
    normalize_image,
    read_image,
    write_image,
)

__all__ = ["IMAGENET_MEAN", "IMAGENET_STD", "normalize_image", "read_image", "write_image", "hwc_to_chw",
           "chw_to_hwc"]
