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
