"""Offline pretrained-backbone converters: torchvision / TF-slim ResNet-50
checkpoints -> the port's ``ResNetV1``.

The port of ``x_detector_tpu/utils/pretrained.py`` (the reference's
ImageNet-init restore with variable-name remapping; training from scratch
stays the default). The port's modules keep torch's layouts, so a
torchvision state dict maps by name alone:

  * ``conv1`` / ``bn1`` -> ``stem.Conv_0`` / ``stem.bn``;
  * ``layer{s}.{b}.conv{i}`` / ``bn{i}`` -> ``stage{s}_block{b}.ConvBN_{i-1}``
    (``.Conv_0`` / ``.bn``);
  * ``layer{s}.{b}.downsample.0`` / ``.1`` -> ``stage{s}_block{b}.proj``;
  * BatchNorm ``weight``, ``bias``, ``running_mean``, ``running_var`` keep
    their names (``num_batches_tracked`` has no counterpart); the ``fc``
    head is dropped.

A TF-slim ``resnet_v1_50`` checkpoint maps its ``block{s}/unit_{u}/
bottleneck_v1/conv{i}`` and ``shortcut`` names the same way, its HWIO
kernels transposed to OIHW, a missing BatchNorm ``gamma`` read as ones;
the logits are dropped. Reading one needs TensorFlow
(:func:`read_tf_checkpoint`), which is imported only then.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

BN_LEAVES = ("weight", "bias", "running_mean", "running_var")
SLIM_BN = {"weight": "gamma", "bias": "beta", "running_mean": "moving_mean",
           "running_var": "moving_variance"}


def _f32(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(v, np.float32))


def torch_resnet50_to_port(state_dict: Mapping[str, object],
                           stage_sizes=(3, 4, 6, 3)
                           ) -> Dict[str, torch.Tensor]:
    """A torchvision ``resnet50().state_dict()`` (tensors or arrays) -> the
    port's ``ResNetV1`` state dict (fp32, CPU), the fc head dropped."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}

    def conv_bn(src_conv: str, src_bn: str, dst: str) -> None:
        out[f"{dst}.Conv_0.weight"] = _f32(sd[f"{src_conv}.weight"])
        for leaf in BN_LEAVES:
            out[f"{dst}.bn.{leaf}"] = _f32(sd[f"{src_bn}.{leaf}"])

    conv_bn("conv1", "bn1", "stem")
    for stage, n_blocks in enumerate(stage_sizes):
        for block in range(n_blocks):
            t = f"layer{stage + 1}.{block}"
            f = f"stage{stage + 1}_block{block}"
            for i in range(3):
                conv_bn(f"{t}.conv{i + 1}", f"{t}.bn{i + 1}",
                        f"{f}.ConvBN_{i}")
            if f"{t}.downsample.0.weight" in sd:
                conv_bn(f"{t}.downsample.0", f"{t}.downsample.1",
                        f"{f}.proj")
    return out


def tf_slim_resnet50_to_port(ckpt: Mapping[str, object],
                             stage_sizes=(3, 4, 6, 3),
                             scope: str = "resnet_v1_50"
                             ) -> Dict[str, torch.Tensor]:
    """A TF-slim ``resnet_v1_50`` checkpoint as a flat name -> array dict
    (:func:`read_tf_checkpoint`) -> the port's ``ResNetV1`` state dict.
    Slim kernels are HWIO and become OIHW; ``BatchNorm/gamma`` absent (a
    ``scale=False`` checkpoint) means ones. Slim puts a block's stride on
    its last unit and torchvision on its first; the shapes are the same and
    the model fixes its own stride layout, so the graft is by name."""
    def g(name: str) -> np.ndarray:
        return np.asarray(ckpt[f"{scope}/{name}"], np.float32)

    out: Dict[str, torch.Tensor] = {}

    def conv_bn(src: str, dst: str) -> None:
        out[f"{dst}.Conv_0.weight"] = torch.from_numpy(np.ascontiguousarray(
            g(f"{src}/weights").transpose(3, 2, 0, 1)))
        for leaf, slim in SLIM_BN.items():
            name = f"{src}/BatchNorm/{slim}"
            if leaf == "weight" and f"{scope}/{name}" not in ckpt:
                value = np.ones_like(g(f"{src}/BatchNorm/beta"))
            else:
                value = g(name)
            out[f"{dst}.bn.{leaf}"] = torch.from_numpy(value)

    conv_bn("conv1", "stem")
    for stage, n_units in enumerate(stage_sizes):
        for unit in range(n_units):
            t = f"block{stage + 1}/unit_{unit + 1}/bottleneck_v1"
            f = f"stage{stage + 1}_block{unit}"
            for i in range(3):
                conv_bn(f"{t}/conv{i + 1}", f"{f}.ConvBN_{i}")
            if f"{scope}/{t}/shortcut/weights" in ckpt:
                conv_bn(f"{t}/shortcut", f"{f}.proj")
    return out


def read_tf_checkpoint(path: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint (a Saver prefix or file) as a flat
    name -> array dict. Needs TensorFlow, imported here only."""
    try:
        import tensorflow as tf
    except ImportError as e:
        raise ImportError(f"reading the TF-slim checkpoint {path!r} needs "
                          f"tensorflow, which is not installed; convert it "
                          f"to a torchvision .pth where TensorFlow is") from e
    reader = tf.train.load_checkpoint(path)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}


def graft_backbone(model: nn.Module, tensors: Mapping[str, torch.Tensor],
                   scope: str = "backbone") -> int:
    """Copy converted backbone ``tensors`` into ``model.<scope>`` in place
    (the heads keep their init: the reference's exclude-logits restore).
    Every tensor must have a target of its shape, or this raises before
    anything is copied. Returns the number of tensors copied."""
    target = model.get_submodule(scope).state_dict(keep_vars=True)
    for name, value in tensors.items():
        if name not in target:
            raise KeyError(f"no target for pretrained {scope}.{name}")
        if tuple(target[name].shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch at {scope}.{name}: "
                             f"{tuple(target[name].shape)} vs "
                             f"{tuple(value.shape)}")
    with torch.no_grad():
        for name, value in tensors.items():
            target[name].copy_(value.to(target[name].dtype))
    return len(tensors)


def load_pretrained_backbone(model: nn.Module, path: str,
                             stage_sizes=(3, 4, 6, 3),
                             scope: str = "backbone") -> int:
    """Graft a pretrained ResNet-50 into ``model``'s backbone, sniffing the
    format: a torchvision ``.pth`` / ``.pt`` state dict, else a TF-slim
    ``resnet_v1_50`` checkpoint prefix. Returns the tensors copied."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        tensors = torch_resnet50_to_port(sd, stage_sizes=stage_sizes)
    else:
        tensors = tf_slim_resnet50_to_port(read_tf_checkpoint(path),
                                           stage_sizes=stage_sizes)
    return graft_backbone(model, tensors, scope=scope)
