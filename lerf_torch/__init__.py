"""lerf_torch — LeRF arbitrary-scale LUT super-resolution in PyTorch and CUDA.

The PyTorch/CUDA counterpart of :mod:`lerf_tpu`, module for module: the
int8 LUT bank (``lut``), host float64 resize geometry and the stage and
resize ops (``ops``), the deploy predictor (``pipeline``), the SR
evaluation harness and the CLIs.  On a CUDA device the LUT stages and the
steerable-Gaussian resize run in hand-written kernels (``csrc/``); on the
CPU they run their plain PyTorch twins.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--platform cpu``); asking for ``cuda`` without a
visible card raises.  This package imports neither JAX nor ``lerf_tpu``.
"""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
