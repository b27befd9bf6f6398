"""Cells cut to a size the CPU tests can run: 64 px images, thin
backbones, batches of 2 (microbatches of 1 a card over four cards); every
other number as the cell states it.

Besides the cells of ``BENCHMARK.json``, the tests run two that no cell
runs yet (``UNLISTED``): the SSD configuration, whose source maps no
public source defines, and config 5 over four ranks, which holds the
data-parallel path and its exchange to the reference."""

import copy
import dataclasses
import json

from benchmark.harness import spec

# name -> (configuration, mix, cards, limits: a file's or the cell's own)
UNLISTED = {
    "ssd_serve_b32": ("ssd_resnet50", "serve_b32_512", 1,
                      {"out_rel": 0.04, "detections_off": 0.002}),
    "lhx_dp4_train_g128": ("config5_dp4", "train_g128_800", 4,
                           "lhx_train_b16"),
}
LISTED = [w["name"] for w in json.loads(
    (spec.ROOT / "BENCHMARK.json").read_text())["workloads"]]
CELLS = LISTED + sorted(UNLISTED)


def load(name: str) -> spec.Cell:
    """A listed cell as the harness loads it, or an unlisted one built
    alike from its files, reporting what the listed cell of its loop
    reports."""
    if name not in UNLISTED:
        return spec.load_cell(name)
    config, traffic, chips, limits = UNLISTED[name]
    here = spec.HERE
    cfg = json.loads((here / "configs" / f"{config}.json").read_text())
    mix = json.loads((here / "traffic" / f"{traffic}.json").read_text())
    cfg["name"], mix["name"] = config, traffic
    like = spec.load_cell("lhx_serve_b16" if mix["loop"] == "serve"
                          else "lhx_train_b16")
    if isinstance(limits, str):
        limits = spec.load_cell(limits).limits
    return dataclasses.replace(like, name=name, chips=chips, config=cfg,
                               traffic=mix, limits=dict(limits))


def tiny_cell(name: str, dtype: str = "float32") -> spec.Cell:
    cell = copy.deepcopy(load(name))
    c = cell.config
    c.update(image_size=64, compute_dtype=dtype)
    if c["backbone"] == "resnet50":
        c.update(backbone_widths=[8, 16, 24, 32], backbone_units=[1, 1, 1, 1])
    else:
        c.update(backbone_widths=[16, 32, 48, 64])
    if "proposals" in c:
        c["proposals"].update(pre_nms_topk=200, post_nms_topk=64)
    t = cell.traffic
    if t["loop"] == "serve":
        t.update(batch=2, pool_batches=2)
    else:
        per = c["train"]["grad_accum_steps"] * cell.chips
        t.update(batch=2 * per if cell.chips == 1 else per, canvas=80,
                 pool_batches=3)
        c["train"]["batch_size"] = t["batch"]
    return cell
