"""The frozen yardstick: the kernels' work formulas and the reference's
FLOP count against hand counts, and the reference's parameter list
against the program's state dict."""

import pytest
import torch

from benchmark.harness import program, spec
from benchmark.reference import nets, roofline
from benchmark.tests.tiny import load


def test_sepconv_work_by_hand():
    # B2 on [1, 4, 4, 8] -> 16 channels with a residual: 16 pixels
    flop, nbytes = roofline.sepconv_work(1, 4, 4, 8, 16, True)
    assert flop == 2 * 16 * 8 * (9 + 16)
    assert nbytes == 16 * (8 + 16 + 16) * 2 + 8 * 16 * 2 + 9 * 8 * 4 + 2 * 16 * 4


def test_psroi_work_by_hand():
    # 1 image, 2 rois, a 7 x 7 grid of 3 channels, a 100-byte map
    flop, nbytes = roofline.psroi_work(1, 2, 147, 100)
    assert flop == 2 * 147 * 2 * 2 * 4 * 2
    assert nbytes == 100 + 2 * 16 + 2 * 147 * 4


def test_bound_takes_the_larger():
    assert roofline.bound_ms(989e9, 0, 989e12) == pytest.approx(1.0)
    assert roofline.bound_ms(0, 3.35e9, 989e12) == pytest.approx(1.0)


def test_config3_sepconv_calls():
    """The 30 stride-1 separable calls of a batch of 16 at Table 7's
    widths, by stage shape: stage 2's first block strides, stage 4 is
    dilated at stride 16."""
    cfg = spec.load_cell("lhx_serve_b16").config
    calls = roofline.sepconv_calls(cfg, 16)
    assert len(calls) == 30
    assert [c[1] for c in calls] == [100] * 7 + [50] * 23
    assert [c[3:5] for c in calls].count((288, 576)) == 1
    assert sum(c[5] for c in calls) == 16         # every unit's second block
    assert calls[0] == (16, 100, 100, 144, 144, True)
    assert calls[-1] == (16, 50, 50, 576, 576, True)


def test_head_flops_by_hand():
    """The RoI head's products at R rois: the only FLOPs the roi count
    moves."""
    cfg = spec.load_cell("lhx_serve_b16").config
    cfg = dict(cfg, image_size=64, backbone_widths=[16, 32, 48, 64])
    r = 10
    hand = 2 * r * (490 * 2048 + 2048 * 21 + 2048 * 4)
    assert (roofline.count_flops(cfg, 1, 2 * r, False)
            - roofline.count_flops(cfg, 1, r, False)) == hand


@pytest.mark.parametrize("cell", ["lhx_serve_b16", "ssd_serve_b32"])
def test_flops_against_the_programs_count(cell):
    """At 64 px the reference's count equals the program's own counter
    (``utils/roofline.count``) on its float model, less B1's formula."""
    from x_detector_tpu_torch import inference
    from x_detector_tpu_torch.utils import roofline as prog_roofline
    c = load(cell).config
    c = dict(c, image_size=64, backbone_widths=[16, 32, 48, 64]
             if c["backbone"] != "resnet50" else [8, 16, 24, 32],
             backbone_units=c["backbone_units"] if c["backbone"] !=
             "resnet50" else [1, 1, 1, 1])
    cfg = program.program_config(c, "train")        # unfused
    model = inference.build_model(cfg.model, "cpu", seed=0,
                                  dtype=torch.float32)
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        _, cost = prog_roofline.count(model, x)
    rois = c.get("proposals", {}).get("post_nms_topk_eval", 0)
    psroi = roofline.psroi_work(1, rois, c.get("thin_channels", 0), 0)[0]
    assert roofline.count_flops(c, 1, rois, False) == pytest.approx(
        cost.flop - psroi, rel=1e-9)


def test_flops_scale_with_the_batch():
    cfg = load("ssd_serve_b32").config
    cfg = dict(cfg, image_size=64, backbone_units=[1, 1, 1, 1])
    assert roofline.count_flops(cfg, 2, 0, False) == 2 * roofline.count_flops(
        cfg, 1, 0, False)
    assert roofline.count_flops(cfg, 1, 0, True) > 2 * roofline.count_flops(
        cfg, 1, 0, False)


@pytest.mark.parametrize("cell", ["lhx_serve_b16", "ssd_serve_b32"])
def test_param_spec_is_the_state_dict(cell):
    from x_detector_tpu_torch import inference
    c = load(cell).config
    cfg = program.program_config(c, "serve")
    with torch.device("meta"):
        model = inference._model_class(cfg.model.family)(cfg.model)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert want == {n: s for n, s, _ in nets.param_spec(c)}
