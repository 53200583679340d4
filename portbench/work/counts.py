"""The least work of a frame's kernels, from shapes alone: the yardstick
of the roofline and ``mfu`` metrics.

A frozen copy of the bring-up script's arithmetic (``k1_work``,
``k2_work``, ``k5_work``, ``imdn_tower_work`` and their constants): later
changes to the program do not move it.  Each count is what the function
needs, whatever the implementation reads again: every input byte read
once, every output byte written once, the operations as the comments
count them.
"""
from __future__ import annotations

import math

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s; float32 outside
# the tensor cores, which also bounds int32 throughput; float64 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
F64_OPS_PER_S = 34e12

# K1, per output pixel and neighbour: the weight 11 (exp counted as 1) and
# the sums 3; per source pixel the decode (int32 codes: 3 divisions, 4
# products, 1 subtraction = 8; float maps: 2ρ - 1, σx·max, σy·max and 2ρ
# = 5); per output the uint8 epilogue (division, rint, clip) 4
K1_OPS_PER_NEIGHBOUR = 14
K1_OPS_PER_SOURCE = 8
K1_FLOAT_OPS_PER_SOURCE = 5
K1_OPS_PER_OUTPUT_U8 = 4
# K2, per pixel, member and output channel: the blend's 5 multiply-adds
K2_OPS_PER_MEMBER_CHANNEL = 10
# K5, per output pixel, channel and neighbour as K1; per output and
# channel the uint8 epilogue with the NaN test, 5; its float64 geometry
# per output: the grid's three row-term adds and two divisions, per axis
# the clip (2), (g - S/2) - eps (2), ceil and + pad, and per distance its
# subtraction and cast (2); per output row and column the grid's products
# and the column's adds (3, 6); the validity mask 8 float64 operations
# and one byte an output
K5_OPS_PER_NEIGHBOUR = 14
K5_OPS_PER_OUTPUT_U8 = 5
K5_F64_OPS_PER_ROW = 3
K5_F64_OPS_PER_COLUMN = 6
K5_F64_MASK_OPS = 8


def bound_s(nbytes: float = 0.0, f32_ops: float = 0.0,
            f64_ops: float = 0.0) -> float:
    """The least seconds of that work on one H100: the largest of its
    times at the bytes' and each operation type's peak."""
    return max(nbytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S,
               f64_ops / F64_OPS_PER_S)


def k1(in_hw, out_hw, c: int = 3, support: int = 2, floats: bool = False):
    """(bytes, float32 operations) of one K1 call in uint8 mode: the
    feature and the 3 codes (int32 or float32, 4 bytes) of every source
    pixel read once, the uint8 output written once, the per-axis geometry
    (rows and distances, 8 bytes a neighbour) read once."""
    (h, w), (oh, ow) = in_hw, out_hw
    nbytes = c * h * w * 4 * 4 + c * oh * ow + (oh + ow) * support * 8
    src = K1_FLOAT_OPS_PER_SOURCE if floats else K1_OPS_PER_SOURCE
    ops = (c * h * w * src + c * oh * ow
           * (support * support * K1_OPS_PER_NEIGHBOUR + K1_OPS_PER_OUTPUT_U8))
    return nbytes, ops


def k2(in_hw, c: int, oc: int, n_tables: int, n_members: int,
       table_rows: int):
    """(bytes, operations) of one K2 call: the int32 image and the int8
    [tables, rows, oC] tables read once, the int32 output written once."""
    h, w = in_hw
    nbytes = c * h * w * 4 + n_tables * table_rows * oc + c * h * w * oc * 4
    return nbytes, c * h * w * n_members * oc * K2_OPS_PER_MEMBER_CHANNEL


def k5(in_hw, out_hw, c: int = 3, support: int = 2, mask: bool = True):
    """(bytes, float32 operations, float64 operations) of one K5 call in
    uint8 mode on int32 codes, with the validity mask."""
    (h, w), (oh, ow) = in_hw, out_hw
    nbytes = c * h * w * 4 * 4 + 9 * 8 + c * oh * ow
    ops = (c * h * w * K1_OPS_PER_SOURCE + c * oh * ow
           * (support * support * K5_OPS_PER_NEIGHBOUR + K5_OPS_PER_OUTPUT_U8))
    f64 = (oh * ow * (5 + 2 * (6 + support * 2))
           + oh * K5_F64_OPS_PER_ROW + ow * K5_F64_OPS_PER_COLUMN)
    if mask:
        nbytes += oh * ow
        f64 += oh * ow * K5_F64_MASK_OPS
    return nbytes, ops, f64


def imdn_towers(conv_shapes, in_hw, in_c: int = 3, out_c: int = 3):
    """(bytes, multiply-adds) of both IMDN towers on one frame: the
    float32 image read once and the feature and hyper maps written once;
    a multiply-add per weight of every conv at every pixel (stride 1)."""
    px = in_hw[0] * in_hw[1]
    macs = sum(math.prod(shape) for shape in conv_shapes) * px
    nbytes = (in_c + in_c + in_c * out_c) * px * 4
    return nbytes, macs
