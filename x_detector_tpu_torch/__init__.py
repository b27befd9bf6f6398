"""x_detector_tpu_torch: the PyTorch/CUDA port of x_detector_tpu.

It runs the Light-Head R-CNN + Xception-lite inference path (BASELINE
config 3) and its training step (config 4) on one NVIDIA H100, with
hand-written CUDA kernels for the fused separable conv and PSROIAlign
(forward and backward). It imports torch and numpy, never JAX.

Layout (module names mirror the JAX package's):
  config.py      the preset tree (same dataclasses as x_detector_tpu.config)
  ops/           anchors, boxes, exact NMS, matching, PSROIAlign, fused
                 separable conv
  csrc/          the CUDA C++ kernels (sm_90a), built at first use by _build
  models/        layers, Xception-lite, backbone factory, Light-Head R-CNN
  data/          train augmentation, eval preprocessing, synthetic data
  train/         losses, lr schedule and optimizer, train state, train step
  inference.py   build_model / build_eval_fn: the inference entry point
  utils/         flax -> torch weight conversion
"""
