"""What decides ``correct`` in a serving cell: the program's outputs of a
batch judged by the plain reference.

The program serves uint8 images through its own preprocessing and
``build_eval_fn``; the harness keeps, for a few batches drawn from the
seed, the model's outputs (a forward hook on the program's model) and the
detections that reached the host. The reference then works every stage out
again in float32 from the same uint8 images and the same weights:

* Light-Head: ``rpn_rel``, the RPN's logits and box codes against the
  reference's (relative L2 error, the worse of the two);
  ``proposals_off``, the share of proposal slots that the reference's
  proposal stage, run on the program's RPN outputs, places otherwise;
  ``head_rel``, the RoI head's logits and codes against the reference's
  thin map, PSROIAlign and head at the program's valid proposals;
* SSD: ``out_rel``, the class logits and box codes against the reference's;
* both: ``detections_off``, the share of detection slots that the
  reference's per-class NMS tail, run on the program's model outputs,
  fills otherwise (class, validity, a box corner or score off by more than
  ``TOL``; empty slots too, which hold zeros and -1).

Light-Head's numbers also give the load its NMS stages took, reported and
not limited: valid proposals (``proposals_per_image``), class scores over
the score threshold (``nms_candidates_per_image``, before the NMS tail's
top 100 a class) and detections kept (``detections_per_image``), each a
mean an image.

The proposal and NMS stages are discrete: they follow the program's own
outputs step by step, and the continuous numbers check the networks that
feed them. ``control_outputs`` is the control: the reference itself with
its products in fp8 and its float32 stages in bfloat16, judged the same
way.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from benchmark.reference import nets, post
from benchmark.reference.precision import fp8

TOL = 1e-5


def anchors(cfg: dict, device) -> torch.Tensor:
    fn = post.rpn_anchors if cfg["family"] == "lighthead" else post.ssd_anchors
    key = "anchors" if cfg["family"] == "lighthead" else "ssd_anchors"
    return torch.from_numpy(fn(cfg["image_size"], cfg[key])).to(device)


def rel(p: torch.Tensor, r: torch.Tensor) -> float:
    """||p - r|| / ||r|| in float64."""
    p, r = p.double(), r.double()
    return float((p - r).norm() / r.norm().clamp_min(1e-300))


def boxes_off(pb, pv, rb, rv) -> Tuple[int, int]:
    """(slots that differ, slots): validity, or a corner off by > TOL."""
    off = (pv != rv) | ((pb.float() - rb.float()).abs().amax(-1) > TOL)
    return int(off.sum()), off.numel()


def detections_off(dets, ref: post.Detections) -> Tuple[int, int]:
    boxes, scores, classes, valid = (t.to(ref.boxes.device) for t in dets)
    off = ((valid != ref.valid) | (classes != ref.classes)
           | ((boxes.float() - ref.boxes).abs().amax(-1) > TOL)
           | ((scores.float() - ref.scores).abs() > TOL))
    return int(off.sum()), off.numel()


def batch_numbers(cfg: dict, params: Dict[str, torch.Tensor],
                  images_u8: torch.Tensor, out, dets) -> Dict[str, tuple]:
    """One batch's numbers, each as (value, count): relative errors with
    count 1, slot shares as (slots off, slots)."""
    dev = images_u8.device
    net = nets.Net(params)
    grid = anchors(cfg, dev)
    x = nets.preprocess_eval(images_u8, cfg)
    with torch.no_grad():
        feats = nets.backbone(net, x, cfg)
        if cfg["family"] == "ssd":
            cls, loc = nets.ssd_heads(net, feats, cfg)
            got = {"out_rel": (max(rel(out[0], cls), rel(out[1], loc)), 1)}
            ref = post.ssd_detections(out[0], out[1], grid, cfg)
            return dict(got, detections_off=detections_off(dets, ref))
        rc, rl = nets.rpn_head(net, feats["c4"])
        got = {"rpn_rel": (max(rel(out["rpn_cls"], rc),
                               rel(out["rpn_loc"], rl)), 1)}
        del rc, rl
        pb, _, pv = post.proposals(out["rpn_cls"].float(),
                                   out["rpn_loc"].float(), grid, cfg)
        got["proposals_off"] = boxes_off(out["proposals"],
                                         out["proposal_valid"], pb, pv)
        thin = nets.thin_map(net, feats["c5"]).permute(0, 2, 3, 1)
        del feats
        props, valid = out["proposals"].float(), out["proposal_valid"]
        pooled = post.psroi_align(thin.contiguous(), props,
                                  grid=cfg["roi_grid"])
        hc, hb = nets.roi_head(net, pooled * valid[..., None, None, None])
        got["head_rel"] = (max(rel(out["roi_cls"][valid], hc[valid]),
                               rel(out["roi_box"][valid], hb[valid])), 1)
        ref = post.lighthead_detections(out["roi_cls"].float(),
                                        out["roi_box"].float(), props, valid,
                                        cfg)
        got["detections_off"] = detections_off(dets, ref)
        b, n = valid.shape[0], cfg["nms"]
        fg = torch.softmax(out["roi_cls"].float(), -1)[..., 1:]
        got["proposals_per_image"] = (int(valid.sum()), b)
        got["nms_candidates_per_image"] = (int(
            ((fg > n["score_threshold"]) & valid[..., None]).sum()), b)
        got["detections_per_image"] = (int(ref.valid.sum()), b)
        return got


def merge(per_batch) -> Dict[str, float]:
    """The worst relative error over the batches; the share of slots off
    over all of them."""
    out = {}
    for name in per_batch[0]:
        vals = [b[name] for b in per_batch]
        if all(c == 1 and isinstance(v, float) for v, c in vals):
            out[name] = max(v for v, _ in vals)
        else:
            out[name] = sum(v for v, _ in vals) / sum(c for _, c in vals)
    return out


def control_outputs(cfg: dict, params, images_u8: torch.Tensor,
                    cast: Callable = fp8, low=torch.bfloat16):
    """The control in the program's place: (model outputs, detections) of
    the reference with ``cast`` on every product's operands and its float32
    stages in ``low``."""
    dev = images_u8.device
    net = nets.Net(params, cast=cast)
    grid = anchors(cfg, dev)
    with torch.no_grad():
        feats = nets.backbone(net, nets.preprocess_eval(images_u8, cfg), cfg)
        if cfg["family"] == "ssd":
            cls, loc = nets.ssd_heads(net, feats, cfg)
            d = post.ssd_detections(cls.to(low), loc.to(low), grid.to(low),
                                    cfg)
            return (cls, loc), _widen(d)
        rc, rl = nets.rpn_head(net, feats["c4"])
        pb, _, pv = post.proposals(rc.to(low), rl.to(low), grid.to(low), cfg)
        pb = pb.float()
        thin = nets.thin_map(net, feats["c5"]).permute(0, 2, 3, 1)
        pooled = post.psroi_align(thin.contiguous(), pb, grid=cfg["roi_grid"])
        hc, hb = nets.roi_head(net, pooled * pv[..., None, None, None])
        d = post.lighthead_detections(hc.to(low), hb.to(low), pb.to(low), pv,
                                      cfg)
        out = {"rpn_cls": rc, "rpn_loc": rl, "proposals": pb,
               "proposal_valid": pv, "roi_cls": hc, "roi_box": hb}
        return out, _widen(d)


def _widen(d: post.Detections):
    return (d.boxes.float(), d.scores.float(), d.classes, d.valid)
