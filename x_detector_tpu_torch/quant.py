"""Post-training int8 quantization of the backbone, for serving.

The port of ``x_detector_tpu/quant.py``. A model built with
``backbone_quant`` set holds :class:`~x_detector_tpu_torch.models.layers.
QuantConv` for every backbone conv (heads, proposals and NMS stay in the
float dtype). The flow::

    qcfg = dataclasses.replace(cfg.model, backbone_quant="int8")
    model = quant.build_detector(qcfg, device)
    model.load_state_dict(float_state)       # a float checkpoint loads as is
    quant.calibrate_backbone(cfg, model, batches)    # fills act_amax
    detect = inference.build_eval_fn(model, cfg, device)
    quant.prequantize(model)     # optional: int8 weights and w_scale held

``calibrate_backbone`` runs the model in calibrate mode (the float path's
convs, the same detections) over a few eval-preprocessed batches and keeps
each conv input's running abs-max (or percentile) in its ``act_amax``. The
int8 model then runs each backbone conv on the int8 kernels
(``ops/int8_conv.py``): per-output-channel weight scales, a per-tensor
static activation scale.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping, Union

import torch
from torch import nn

from x_detector_tpu_torch import inference
from x_detector_tpu_torch.models.layers import (QuantConv,
                                                prepare_for_inference)
from x_detector_tpu_torch.ops.int8_conv import quantize_weight


def build_detector(model_cfg, device="cuda",
                   dtype: torch.dtype = torch.bfloat16) -> inference.Model:
    """The config's detector (family dispatch, as ``inference.build_model``)
    on ``device`` in eval mode, its weights left to be loaded."""
    return inference.build_model(model_cfg, device, seed=None, dtype=dtype)


def quant_convs(model: nn.Module) -> Dict[str, QuantConv]:
    """The model's QuantConv modules by state-dict prefix."""
    return {name: m for name, m in model.named_modules()
            if isinstance(m, QuantConv)}


def calibrate_backbone(cfg, model: nn.Module,
                       batches: Iterable[torch.Tensor],
                       percentile: float = 100.0) -> Dict[str, torch.Tensor]:
    """Static activation ranges for every backbone conv of ``model`` (built
    with ``backbone_quant`` set, e.g. the int8 model to serve).

    Runs ``model`` in eval mode with each QuantConv in calibrate mode
    ("calibrate", or "calibrate:p<percentile>" below 100) over ``batches``
    (eval-preprocessed [B, S, S, 3] images), from ``act_amax`` = 0: the
    running max of each batch's statistic. Leaves the ranges in the
    ``act_amax`` buffers, the modes and the train flag as they were (a
    model in eval mode prepared anew for the new ranges,
    ``models.layers.prepare_for_inference``), and returns the ranges keyed
    as in the state dict. On an empty stream, or an error, it raises and
    leaves the ranges as they were."""
    convs = quant_convs(model)
    if not convs:
        raise ValueError(f"{cfg.model.name}: the model has no QuantConv; "
                         f"build it with backbone_quant set")
    mode = "calibrate" if percentile >= 100.0 else f"calibrate:p{percentile}"
    before = {name: (m.mode, m.act_amax.clone())
              for name, m in convs.items()}
    was_training = model.training
    device = next(model.parameters()).device
    seen = 0
    try:
        model.eval()
        with torch.no_grad():
            for m in convs.values():
                m.mode = mode
                m.act_amax.zero_()
            for images in batches:
                model(images.to(device))
                seen += 1
        if not seen:
            raise ValueError("calibrate_backbone needs at least one batch")
    except BaseException:
        with torch.no_grad():
            for name, m in convs.items():
                m.act_amax.copy_(before[name][1])
        raise
    finally:
        for name, m in convs.items():
            m.mode = before[name][0]
        model.train(was_training)
    if not was_training:
        prepare_for_inference(model)
    return {f"{name}.act_amax": m.act_amax.detach().clone()
            for name, m in convs.items()}


def prequantize(target: Union[nn.Module, Mapping[str, torch.Tensor]]):
    """Hold the int8 weights: each calibrated conv's weight quantized once,
    by the formula QuantConv applies (``quantize_weight``), as int8 with
    its [Cout] ``w_scale``.

    ``target`` is a model (changed in place and returned; in eval mode its
    operands prepared anew) or its state dict (a new dict is returned).
    Raises, changing nothing, when a conv's weight is already int8, when an
    ``act_amax`` is not positive (an uncalibrated conv would saturate every
    activation) or when there is no calibrated conv."""
    if isinstance(target, nn.Module):
        convs = {name: (m.weight, m.act_amax)
                 for name, m in quant_convs(target).items()}
    else:
        convs = {key[:-len(".act_amax")]: (target[key[:-len("act_amax")]
                                                  + "weight"], target[key])
                 for key in target if key.endswith(".act_amax")}
    for name, (weight, amax) in convs.items():
        if weight.dtype == torch.int8:
            raise ValueError(f"{name}: the weight is already int8: "
                             f"prequantize was applied twice")
        if not float(amax.max()) > 0.0:
            raise ValueError(f"{name}: act_amax is not positive: the conv "
                             f"is uncalibrated; run calibrate_backbone over "
                             f"representative batches first")
    if not convs:
        raise ValueError("no calibrated convs found")
    quantized = {name: quantize_weight(weight.detach())
                 for name, (weight, _) in convs.items()}
    if isinstance(target, nn.Module):
        modules = dict(target.named_modules())
        for name, (wq, sw) in quantized.items():
            modules[name].set_int8_weight(wq, sw)
        if not target.training:
            prepare_for_inference(target)
        return target
    state = dict(target)
    for name, (wq, sw) in quantized.items():
        state[f"{name}.weight"] = wq
        state[f"{name}.w_scale"] = sw
    return state
