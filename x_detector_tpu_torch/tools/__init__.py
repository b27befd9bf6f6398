"""Accuracy harnesses: train a detector on the synthetic stream, then score
held-out mAP of the same weights along the paths that serving may take.

The ports of the JAX package's ``tools/`` A/Bs, each run as ``python -m
x_detector_tpu_torch.tools.<name>``, on the card unless ``--device cpu``
is passed (``--smoke`` shrinks the models to the tests' size):

  * ``fast_nms_ab`` -- the shared recipe (``capstone_config``,
    ``train_synthetic``, ``make_detect_fn``, ``eval_map``, ``throughput``)
    and exact NMS against MaxpoolNMS;
  * ``train_synthetic_capstone`` -- config 3 trained for 12000 steps, its
    held-out mAP and per-class AP;
  * ``quant_ab`` -- the bf16 against the int8 backbone;
  * ``ema_ab`` -- SSD's raw parameters against its EMA shadow;
  * ``calib_sensitivity`` -- amax against percentile calibration under
    hot-pixel noise;
  * ``overfit`` -- 8 fixed images trained to a near-perfect mAP (the body
    of ``tests/test_torch_overfit.py``, at any width).

and the ports of its rehearsals and parity record:

  * ``rehearse_config5`` -- config 5's data-parallel run, hard-killed
    right after a checkpoint and resumed, bitwise equal to an
    uninterrupted run;
  * ``rehearse_voc_pipeline`` -- a generated VOCdevkit through every CLI,
    each stage a fresh process, down to a reloaded exported program;
  * ``config1_parity`` -- config 1's detections of one image as canonical
    JSON, and ``--compare`` against another record.

and the ports of its measurement tools, ``bench_*``: each measures what the
JAX tool of the same name measures, at its presets and defaults, and prints
JSON lines with its keys, every line with a number beside the card's name
and power limit (``utils.profiling.card_label``). They run on the card
(``--device cpu`` and ``--smoke`` run their whole path at the tests' size,
no measurement), time with CUDA events or a synchronize as the fence over
inputs staged on the card first, report a median and the rounds' spread,
and read the kernels' launches from their ``xdt`` operators' counters:

  * ``bench_cpu_config1`` -- config 1, one 800 px image on the CPU (the
    CPU only), fp32 and bf16;
  * ``bench_detect`` -- images/s of any preset through ``build_eval_fn``;
  * ``bench_infer`` -- cumulative stages (backbone, model, +postprocess):
    ms, FLOPs, MFU and the bandwidth floor (``utils.roofline.count``);
  * ``bench_train`` -- config 4's train step: ms, images/s, FLOPs a step,
    MFU, peak memory;
  * ``bench_serving`` -- buckets 1, 4, 8 and 16 eager and from
    ``serving.DetectorContainer``;
  * ``bench_preproc`` -- the native loader's images/s and the device
    augmentation's;
  * ``bench_nms_tail`` -- config 2's postprocess tail, exact against
    MaxpoolNMS;
  * ``bench_psroi``, ``bench_fused_sepconv``, ``bench_int8``,
    ``bench_depthwise`` -- kernels B1, B2 and K1-K3 (and cuDNN's
    depthwise) at the configs' shapes, each beside its plain version or
    yardstick and its bound.
"""

import os

# the checkout's root: the directory that holds the package
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def repo_env(**extra: str) -> dict:
    """This process's environment and ``extra``, with the checkout's root
    first on PYTHONPATH: for subprocesses that run ``python -m
    x_detector_tpu_torch...`` from any directory."""
    env = dict(os.environ, **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    return env


def add_device_args(p) -> None:
    """``--device`` (the card by default) and ``--smoke``, which every
    harness and measurement tool takes."""
    p.add_argument("--device", default="cuda",
                   help="torch device (default: cuda; a run that finds no "
                        "card fails rather than use the CPU)")
    p.add_argument("--smoke", action="store_true",
                   help="the tests' sizes: the tool's whole path on the "
                        "CPU, not a measurement")
