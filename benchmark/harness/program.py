"""The program under test, as the benchmark drives it: its configuration
built from a configuration file (the preset, then every size the file
states, then the file's path switches for the mode), and its model loaded
with the benchmark's weights.
"""

from __future__ import annotations

import dataclasses

import torch

# configuration-file keys that are ModelConfig fields of the same name
MODEL_SCALARS = ("image_size", "num_classes", "thin_channels",
                 "large_sep_kernel", "large_sep_mid", "roi_grid", "rpn_mid",
                 "head_dim", "class_agnostic_box")


def program_config(cfgj: dict, mode: str):
    """The port's ExperimentConfig for configuration file ``cfgj`` in
    ``mode`` ("serve" or "train")."""
    from x_detector_tpu_torch import config as C
    cfg = C.PRESETS[cfgj["preset"]](cfgj["image_size"])
    m = cfg.model
    nested = {}
    for key, cls in (("anchors", C.AnchorConfig), ("proposals",
                                                   C.ProposalConfig),
                     ("nms", C.NMSConfig), ("ssd_anchors",
                                            C.SSDAnchorConfig)):
        if key in cfgj:
            nested[key] = cls(**{k: tuple(v) if isinstance(v, list) else v
                                 for k, v in cfgj[key].items()})
    model = dataclasses.replace(
        m, backbone=cfgj["backbone"], family=cfgj["family"],
        backbone_widths=tuple(cfgj["backbone_widths"]),
        backbone_stages=tuple(cfgj["backbone_units"]),
        **{k: cfgj[k] for k in MODEL_SCALARS if k in cfgj}, **nested,
        **cfgj["paths"][mode])
    data = dataclasses.replace(cfg.data, image_size=cfgj["image_size"],
                               pixel_means=tuple(cfgj["pixel_means"]),
                               **_fields(cfgj.get("data", {})))
    train = dataclasses.replace(cfg.train, **_fields(cfgj.get("train", {})))
    return dataclasses.replace(cfg, model=model, data=data, train=train)


def _fields(section: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in section.items()}


def build_training(cfgj: dict, params, device, world: int = 1):
    """(cfg, state, step): the port's train state holding ``params`` and
    its ``make_train_step``, or over ``world`` ranks of the group this
    process is one of, its ``make_dp_train_step``."""
    from x_detector_tpu_torch.train import trainer
    cfg = program_config(cfgj, "train")
    state = trainer.create_model_and_state(cfg, device, seed=None,
                                           dtype=dtype_of(cfgj))
    state.model.load_state_dict(params, strict=True)
    if state.ema_params is not None:
        for name, p in state.model.named_parameters():
            state.ema_params[name].copy_(p.detach())
    if world > 1:
        from x_detector_tpu_torch.parallel.data_parallel import (
            make_dp_train_step)
        return cfg, state, make_dp_train_step(state.model, cfg)
    return cfg, state, trainer.make_train_step(state.model, cfg)


def dtype_of(cfgj: dict) -> torch.dtype:
    return getattr(torch, cfgj["compute_dtype"])


def build_serving(cfgj: dict, params, device):
    """(model, detect): the port's model in eval mode holding ``params``
    (strictly: every name and shape must match), and its
    ``build_eval_fn``."""
    from x_detector_tpu_torch import inference
    cfg = program_config(cfgj, "serve")
    model = inference.build_model(cfg.model, device, seed=None,
                                  dtype=dtype_of(cfgj))
    model.load_state_dict(params, strict=True)
    return cfg, model, inference.build_eval_fn(model, cfg, device)


def kernel_launches() -> int:
    """The program's kernel launches so far (its wrappers' counters)."""
    from x_detector_tpu_torch.ops import library
    return int(sum(library.launch_counts().values()))
