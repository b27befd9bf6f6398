"""x_detector_tpu_torch: the PyTorch/CUDA port of x_detector_tpu.

It runs inference of both detector families on one NVIDIA H100 (Light-Head
R-CNN on Xception-lite or ResNet-50, configs 3 and 1; the SSD / X-Det
single-shot detectors, config 2 and ``xdet_xception``) and trains both
(config 4's Light-Head step; config 2's SSD step with its EMA shadow and
``xdet_xception``'s), on one card or data-parallel (config 5), from VOC
TFRecord shards or synthetic data, with checkpoints that resume and the
train, evaluate and convert_voc CLIs; it serves an int8 backbone, and
exports either family as ``torch.export`` programs or containers that a
process without model code loads (serving.py, the export and predict
CLIs). Hand-written CUDA kernels carry the fused separable conv,
PSROIAlign (forward and backward) and the int8 convolutions, each reached
through its ``xdt`` operator (ops/library.py). It imports torch and numpy,
never JAX.

Layout (module names mirror the JAX package's):
  config.py      the preset tree (same dataclasses as x_detector_tpu.config)
  ops/           anchors, boxes, exact NMS, matching, PSROIAlign, fused
                 separable conv, int8 convs, the xdt operators (library.py)
  csrc/          the CUDA C++ kernels (sm_90a), built at first use by _build
  models/        layers, Xception-lite, ResNet-50, the SSD head and model,
                 Light-Head R-CNN
  data/          train augmentation, eval preprocessing, synthetic data,
                 VOC parsing, TFRecord shards (no TensorFlow), the native
                 loader's binding
  native/        the loader's C++ (libjpeg or nvJPEG), built at first use
  parallel/      process groups and the data-parallel train step
  train/         losses (RPN, OHEM, SSD mining), lr schedule and optimizer,
                 train state, train step, checkpoints
  cli/           ``python -m x_detector_tpu_torch.cli.train``,
                 ``.cli.evaluate``, ``.cli.export``, ``.cli.predict``
                 (``--device cuda`` by default) and ``.cli.convert_voc``
  inference.py   build_model / build_eval_fn: the inference entry point;
                 ServingModule, the function that export freezes
  quant.py       int8 post-training quantization of the backbone
  serving.py     load exported programs and containers, letterbox inputs
  utils/         flax -> torch weight conversion, metrics logger, VOC mAP,
                 drawing
"""
