"""x_detector_tpu_torch: the PyTorch/CUDA port of x_detector_tpu.

It runs inference of both detector families on one NVIDIA H100 (Light-Head
R-CNN on Xception-lite or ResNet-50, configs 3 and 1; the SSD / X-Det
single-shot detectors, config 2 and ``xdet_xception``) and trains both
(config 4's Light-Head step; config 2's SSD step with its EMA shadow and
``xdet_xception``'s), with checkpoints that resume and the train and
evaluate CLIs over synthetic data. Hand-written CUDA kernels carry the
fused separable conv and PSROIAlign (forward and backward). It imports
torch and numpy, never JAX.

Layout (module names mirror the JAX package's):
  config.py      the preset tree (same dataclasses as x_detector_tpu.config)
  ops/           anchors, boxes, exact NMS, matching, PSROIAlign, fused
                 separable conv
  csrc/          the CUDA C++ kernels (sm_90a), built at first use by _build
  models/        layers, Xception-lite, ResNet-50, the SSD head and model,
                 Light-Head R-CNN
  data/          train augmentation, eval preprocessing, synthetic data
  train/         losses (RPN, OHEM, SSD mining), lr schedule and optimizer,
                 train state, train step, checkpoints
  cli/           ``python -m x_detector_tpu_torch.cli.train`` and
                 ``.cli.evaluate`` (``--device cuda`` by default)
  inference.py   build_model / build_eval_fn: the inference entry point
  utils/         flax -> torch weight conversion, metrics logger, VOC mAP
"""
