"""lerf_torch — LeRF arbitrary-scale super-resolution in PyTorch and CUDA.

The PyTorch/CUDA counterpart of :mod:`lerf_tpu`, module for module: the
int8 LUT bank (``lut``), the micro-net (SRNet) models and their checkpoint
conversion (``models``), host float64 resize geometry and the stage and
resize and warp ops (``ops``), the two deploy predictors (``pipeline``:
the LUT form and the micro-net form, each in LeRF-G and LeRF-L, with SR,
its bucketed, dynamic-scale and batched serving forms, and the static
homographic warp), the SR and warp evaluation harnesses, training
(``train``, ``data``: the SRNet ensemble, IMDN2 and LUT fine-tuning) and
the CLIs.  On a CUDA device the hot loops run in hand-written kernels
(``csrc/``): K1 the steerable resize (Gaussian or amplified-linear), K2 a
LUT stage, K3 a float micro-net ensemble stage, K4 its int8 form, K5 the
steerable warp (either kernel, any support) and K6 the training resize's
backward; on the CPU they run their plain PyTorch twins.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--platform cpu``); asking for ``cuda`` without a
visible card raises.  This package imports neither JAX nor ``lerf_tpu``.
"""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
