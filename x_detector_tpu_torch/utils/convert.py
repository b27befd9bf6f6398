"""Carry JAX/flax weights into the port's modules."""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def from_jax_variables(variables_np: Mapping) -> Dict[str, torch.Tensor]:
    """The flax ``{"params", "batch_stats", "quant"}`` tree (numpy leaves,
    key paths as flax names them, e.g.
    ``params/backbone/stage4/sep0b/Conv_1/kernel``) -> a ``state_dict`` for
    the port's module of the same structure.

    Conv kernels HWIO ``[kh, kw, cin/groups, cout]`` become OIHW (a depthwise
    ``[3, 3, 1, C]`` becomes ``[C, 1, 3, 3]``), int8 ones (``quant.
    prequantize``'s) staying int8; Dense ``[in, out]`` becomes Linear
    ``[out, in]``; BatchNorm ``scale/bias`` and ``mean/var`` become
    ``weight/bias`` and ``running_mean/running_var``; the ``quant``
    collection's ``act_amax`` and ``w_scale`` keep their names (QuantConv's
    buffers). The fused and unfused separable blocks share one parameter
    tree, so one mapping serves both.
    """
    leaf_names = {("params", "scale"): "weight", ("params", "bias"): "bias",
                  ("batch_stats", "mean"): "running_mean",
                  ("batch_stats", "var"): "running_var",
                  ("quant", "act_amax"): "act_amax",
                  ("quant", "w_scale"): "w_scale"}
    state = {}
    for collection in ("params", "batch_stats", "quant"):
        for path, value in _flatten(variables_np.get(collection, {})):
            *module, leaf = path
            if (collection, leaf) == ("params", "kernel"):
                if value.ndim == 4:
                    value = value.transpose(3, 2, 0, 1)     # HWIO -> OIHW
                elif value.ndim == 2:
                    value = value.T                         # Dense -> Linear
                else:
                    raise ValueError(f"kernel of rank {value.ndim} at "
                                     f"{'/'.join(path)}")
                name = "weight"
            elif (collection, leaf) in leaf_names:
                name = leaf_names[(collection, leaf)]
            else:
                raise KeyError(f"no mapping for {collection}/"
                               f"{'/'.join(path)}")
            key = ".".join([*module, name])
            dtype = torch.int8 if value.dtype == np.int8 else torch.float32
            state[key] = torch.tensor(value, dtype=dtype).contiguous()
    return state
