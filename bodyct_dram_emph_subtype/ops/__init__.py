"""Pure-JAX functional op layer (the reference's L0, rebuilt on device).

Reference L0 lives in ``functional.py`` (torch ops); here every op is a
shape-static, jit/vmap-friendly JAX function so the whole preprocessing +
augmentation chain can run fused on device.
"""
from .intensity import (
    box_cutout,
    contrast_stretching,
    gaussian_additive_noise,
    gaussian_kernel_1d,
    gaussian_smooth,
    intensity_window,
    standardize,
)
from .grid_sample import (
    axis_aligned_grid_sample,
    crop_and_resize,
    grid_sample_3d,
)
from .masked_pool import lung_masked_fraction
from .preprocess import (
    fused_preprocess,
    fused_preprocess_preselected,
    preprocess_one,
    preprocess_one_preselected,
)
from .morphology import (
    binary_dilate,
    binary_dilate_np,
    find_crops_np,
    mask_bbox,
    pad_bbox_mm,
)
from .resize import (
    depth_linspace_indices,
    interpolate_volume,
    linear_gather_1d,
    nearest_gather_1d,
    resize_linear,
    resize_nearest,
    upsample_trilinear,
)

__all__ = [
    "axis_aligned_grid_sample",
    "binary_dilate",
    "binary_dilate_np",
    "box_cutout",
    "contrast_stretching",
    "crop_and_resize",
    "depth_linspace_indices",
    "find_crops_np",
    "fused_preprocess",
    "fused_preprocess_preselected",
    "gaussian_additive_noise",
    "gaussian_kernel_1d",
    "gaussian_smooth",
    "grid_sample_3d",
    "intensity_window",
    "interpolate_volume",
    "linear_gather_1d",
    "lung_masked_fraction",
    "mask_bbox",
    "nearest_gather_1d",
    "pad_bbox_mm",
    "preprocess_one",
    "preprocess_one_preselected",
    "resize_linear",
    "resize_nearest",
    "standardize",
    "upsample_trilinear",
]
