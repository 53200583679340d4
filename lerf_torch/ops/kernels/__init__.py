"""Hand-written CUDA kernels of the port and their wrappers.

* K1 ``resize.steering_resize`` (and ``steering_resize_serving``, the
  same kernel on the serving geometry) — ``csrc/steering_resize.cu``
* K2 ``lut_stage.lut_stage`` — ``csrc/lut_stage.cu``
* K3 ``srnet_ensemble.ensemble_sum`` — ``csrc/srnet_ensemble.cu``
* K4 ``srnet_ensemble_int8.ensemble_sum_int8`` —
  ``csrc/srnet_ensemble_int8.cu``
* K5 ``warp.steering_warp`` — ``csrc/steering_warp.cu``
* K6 ``resize_bwd.steering_resize_grad``, the training resize's backward
  (behind ``resize.steering_resize_train``) —
  ``csrc/steering_resize_bwd.cu``

Each wrapper runs its plain PyTorch twin for CPU tensors and launches its
kernel for CUDA tensors, counting launches in the module's ``launches``.
The kernels build with nvcc at first launch (``_build``), never at import.
"""
