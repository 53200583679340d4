"""Geometry, LUT-stage, resize and warp ops of the port (see the
submodules): lerf_tpu.ops's public names, each from the port's own
module, but for those in ``LEFT_OUT`` (none now)."""
from .geometry import (ResizeGeometry, ResizeOperands, WarpGeometry,
                       WarpOperands, resolve_scale_and_out_sz)
from .resample import (
    amplified_linear_resize,
    amplified_linear_resize_rings,
    amplified_linear_warp,
    amplified_linear_warp_rings,
    fixed_kernel_resize,
    fixed_kernel_warp,
    nearest_warp_mask,
    nearest_warp_mask_host,
    resize,
    resize_rings,
    steering_gaussian_resize,
    steering_gaussian_resize_rings,
    steering_gaussian_warp,
    steering_gaussian_warp_rings,
    warp_rings,
    warp_serving_host,
)
from .simplex import (
    build_cell_table,
    round_half_even_div,
    simplex4d,
    simplex4d_cells,
)
from .lut_pipeline import (
    MODE_OFFSETS,
    MODE_PAD,
    lut_ensemble,
    lut_stage1,
    lut_stage2,
    split_gaussian_hyper,
)

# lerf_tpu.ops names the port leaves out on purpose, each as (name, reason)
LEFT_OUT = ()

__all__ = [
    "ResizeGeometry", "ResizeOperands", "WarpGeometry", "WarpOperands",
    "resolve_scale_and_out_sz",
    "steering_gaussian_resize", "amplified_linear_resize",
    "steering_gaussian_resize_rings", "amplified_linear_resize_rings",
    "resize_rings",
    "fixed_kernel_resize", "resize",
    "steering_gaussian_warp", "amplified_linear_warp",
    "steering_gaussian_warp_rings", "amplified_linear_warp_rings",
    "warp_rings", "nearest_warp_mask_host", "warp_serving_host",
    "fixed_kernel_warp", "nearest_warp_mask", "simplex4d", "simplex4d_cells",
    "build_cell_table",
    "round_half_even_div", "lut_ensemble", "lut_stage1", "lut_stage2",
    "split_gaussian_hyper", "MODE_OFFSETS", "MODE_PAD",
]
