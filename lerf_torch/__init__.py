"""lerf_torch — LeRF arbitrary-scale super-resolution in PyTorch and CUDA.

The PyTorch/CUDA counterpart of :mod:`lerf_tpu`, module for module: the
int8 LUT bank and the transfer of trained micro-nets to it (``lut``), the
micro-net (SRNet) and IMDN (LeRF-Net) models and their checkpoint
conversion (``models``), host float64 resize and warp geometry and the
stage, resize and warp ops (``ops``), the deploy predictors
(``pipeline``: the LUT form, the micro-net form and the IMDN form, each in
LeRF-G and LeRF-L, with SR and its bucketed, dynamic-scale and batched
serving forms, and the homographic warp and its dynamic, device and
batched serving forms, each with its async form), the serving runtime
(``serve``: the streaming engine and the HTTP daemon), the SR and warp
evaluation harnesses, the ResizeRight-style ``ops.resize``, training
(``train``, ``data``: the SRNet ensemble, IMDN2 and LUT fine-tuning, with
TensorBoard event files beside ``scalars.jsonl``) and the CLIs.  On a CUDA
device the hot loops run in hand-written kernels (``csrc/``): K1 the
steerable resize (Gaussian or amplified-linear), K2 a LUT stage, K3 a
float micro-net ensemble stage, K4 its int8 form, K5 the steerable warp
(either kernel, any support, a batch of homographies) and K6 the training
resize's backward; on the CPU they run their plain PyTorch twins.  The
multi-device layer (``parallel``: a mesh of devices, a device possibly
repeated, one stream a shard) runs the deploy paths row-sharded, the
predictors' batches and the trainer's steps data-parallel.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--platform cpu``); asking for ``cuda`` without a
visible card raises.  This package imports neither JAX nor ``lerf_tpu``.
"""

from .device import resolve_device

__version__ = "0.1.0"
__all__ = ["resolve_device"]
