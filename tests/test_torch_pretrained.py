"""The port's pretrained ResNet-50 graft (``utils/pretrained.py``) and
``cli.train --pretrained``, against torch's own forward and the JAX
package's converters.

The cases of ``tests/test_pretrained.py`` restated on the port, with its
torchvision-shaped ResNet-50 (random values; no weights are on disk or
fetched) and its slim renaming; TensorFlow is on this host for the slim
checkpoint cases. Tolerances: the converted tensors bitwise (a rename, and
for slim a transpose); the port's backbone against torch's eval-mode
activations at the JAX package's 1e-4 (fp32 in other orders).
"""

import builtins
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from test_pretrained import _slim_dict_from_torch, _TorchResNet50  # noqa
from x_detector_tpu.utils.pretrained import torch_resnet50_to_flax  # noqa
from x_detector_tpu_torch.cli import train  # noqa: E402
from x_detector_tpu_torch.config import ssd_resnet50  # noqa: E402
from x_detector_tpu_torch.models.resnet import resnet50  # noqa: E402
from x_detector_tpu_torch.models.ssd import SSDModel  # noqa: E402
from x_detector_tpu_torch.utils import pretrained  # noqa: E402
from x_detector_tpu_torch.utils.convert import from_jax_variables  # noqa: E402


@pytest.fixture(scope="module")
def tiny_torch_resnet():
    torch.manual_seed(0)
    m = _TorchResNet50()
    with torch.no_grad():
        for p in m.parameters():
            p.normal_(0, 0.02)
        for mod in m.modules():
            if isinstance(mod, torch.nn.BatchNorm2d):
                mod.running_mean.normal_(0, 0.1)
                mod.running_var.uniform_(0.5, 1.5)
    return m.eval()


def _port_backbone():
    return resnet50(dilate_c5=False, dtype=torch.float32).eval()


def test_conversion_structure(tiny_torch_resnet):
    """Every converted tensor has a target of its shape in the port's
    ResNet-50, the fc head is dropped, and the tensors equal the JAX
    package's conversion carried by ``from_jax_variables``."""
    sd = tiny_torch_resnet.state_dict()
    got = pretrained.torch_resnet50_to_port(sd)
    target = _port_backbone().state_dict()
    assert set(got) == set(target)
    for k, v in got.items():
        assert v.shape == target[k].shape, k
    params, stats = torch_resnet50_to_flax(sd)
    want = from_jax_variables({"params": params, "batch_stats": stats})
    assert set(want) == set(got)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_forward_parity_with_torch(tiny_torch_resnet):
    """The grafted backbone against torch's eval-mode activations."""
    model = _port_backbone()
    assert pretrained.graft_backbone(
        _holder(model),
        pretrained.torch_resnet50_to_port(tiny_torch_resnet.state_dict())
    ) == len(model.state_dict())
    x = np.random.default_rng(0).normal(0, 1, (1, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        feats = model(torch.from_numpy(x))
        m = tiny_torch_resnet
        h = m.layer1(m.maxpool(m.relu(m.bn1(m.conv1(torch.from_numpy(
            x).permute(0, 3, 1, 2))))))
        c3 = m.layer2(h)
        c4 = m.layer3(c3)
        c5 = m.layer4(c4)
    for name, ref in (("c3", c3), ("c4", c4), ("c5", c5)):
        np.testing.assert_allclose(feats[name].numpy(), ref.numpy(),
                                   atol=1e-4, rtol=1e-4, err_msg=name)


def _holder(backbone):
    holder = torch.nn.Module()
    holder.backbone = backbone
    return holder


def test_graft_keeps_head_init(tiny_torch_resnet):
    model = SSDModel(ssd_resnet50(64).model, dtype=torch.float32)
    head_before = model.head.cls0.weight.detach().clone()
    tensors = pretrained.torch_resnet50_to_port(
        tiny_torch_resnet.state_dict())
    pretrained.graft_backbone(model, tensors)
    assert torch.equal(model.backbone.stem.Conv_0.weight,
                       tensors["stem.Conv_0.weight"])
    assert torch.equal(model.head.cls0.weight, head_before)


def test_graft_raises_on_a_tensor_without_a_target(tiny_torch_resnet):
    """A name with no target, or a shape that differs, raises before any
    tensor is copied."""
    model = _holder(_port_backbone())
    before = model.backbone.stem.Conv_0.weight.detach().clone()
    tensors = pretrained.torch_resnet50_to_port(
        tiny_torch_resnet.state_dict())
    with pytest.raises(KeyError, match="no target"):
        pretrained.graft_backbone(model, {**tensors,
                                          "stage9_block0.w": before})
    with pytest.raises(ValueError, match="shape mismatch"):
        pretrained.graft_backbone(model, {**tensors, "stem.Conv_0.weight":
                                          before[:1]})
    assert torch.equal(model.backbone.stem.Conv_0.weight, before)


def test_tf_slim_mapping_equals_torch_mapping(tiny_torch_resnet):
    sd = {k: v.numpy() for k, v in tiny_torch_resnet.state_dict().items()}
    want = pretrained.torch_resnet50_to_port(sd)
    slim = _slim_dict_from_torch(sd)
    got = pretrained.tf_slim_resnet50_to_port(slim)
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # a scale=False checkpoint: gamma absent reads as ones
    del slim["resnet_v1_50/conv1/BatchNorm/gamma"]
    got = pretrained.tf_slim_resnet50_to_port(slim)
    assert torch.equal(got["stem.bn.weight"], torch.ones(64))


def _save_slim(tf, slim, path):
    with tf.Graph().as_default():
        for name, val in slim.items():
            tf.compat.v1.get_variable(name, initializer=val)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            tf.compat.v1.train.Saver().save(sess, path)


def test_tf_checkpoint_reader_roundtrip(tiny_torch_resnet, tmp_path):
    """read_tf_checkpoint on a genuine Saver checkpoint with slim names
    returns every tensor bit for bit; converted, it grafts."""
    tf = pytest.importorskip("tensorflow")
    sd = {k: v.numpy() for k, v in tiny_torch_resnet.state_dict().items()}
    slim = _slim_dict_from_torch(sd)
    path = str(tmp_path / "resnet_v1_50.ckpt")
    _save_slim(tf, slim, path)
    back = pretrained.read_tf_checkpoint(path)
    assert set(back) == set(slim)
    for name in slim:
        np.testing.assert_array_equal(back[name], slim[name], err_msg=name)
    model = _holder(_port_backbone())
    pretrained.graft_backbone(model,
                              pretrained.tf_slim_resnet50_to_port(back))
    with torch.no_grad():
        feats = model.backbone(torch.zeros(1, 64, 64, 3))
    assert feats["c5"].shape[1] == 2048


def test_load_pretrained_backbone_sniffs_both_formats(tiny_torch_resnet,
                                                      tmp_path):
    """A .pth goes to the torchvision converter, a checkpoint prefix to the
    slim one; both graft the same tensors."""
    tf = pytest.importorskip("tensorflow")
    sd = tiny_torch_resnet.state_dict()
    pth = str(tmp_path / "r50.pth")
    torch.save(sd, pth)
    ckpt = str(tmp_path / "r50_slim.ckpt")
    _save_slim(tf, _slim_dict_from_torch({k: v.numpy()
                                          for k, v in sd.items()}), ckpt)
    fresh = _holder(_port_backbone())
    stem0 = fresh.backbone.stem.Conv_0.weight.detach().clone()
    a, b = _holder(_port_backbone()), _holder(_port_backbone())
    assert pretrained.load_pretrained_backbone(a, pth) == len(
        a.backbone.state_dict())
    pretrained.load_pretrained_backbone(b, ckpt)
    sa, sb = a.state_dict(), b.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["backbone.stem.Conv_0.weight"], stem0)


def test_reader_without_tensorflow_names_it(monkeypatch):
    """Where TensorFlow is missing (the card's machine), reading a slim
    checkpoint raises an ImportError that names it."""
    real_import = builtins.__import__

    def no_tf(name, *args, **kwargs):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real_import(name, *args, **kwargs)

    monkeypatch.delitem(sys.modules, "tensorflow", raising=False)
    monkeypatch.setattr(builtins, "__import__", no_tf)
    with pytest.raises(ImportError, match="tensorflow"):
        pretrained.read_tf_checkpoint("resnet_v1_50.ckpt")


THIN = ["--image-size", "64", "--batch-size", "2", "--backbone-stages",
        "1,1,1,1", "--backbone-widths", "8,16,24,32", "--device", "cpu",
        "--dtype", "float32"]


def test_cli_train_pretrained_grafts_and_reseeds_the_ema(tmp_path, capsys):
    """cli.train --pretrained on ssd_resnet50 (EMA 0.99, thin): the backbone
    right after the graft is the file's, the EMA shadow equals the grafted
    parameters (re-seeded, not the discarded init), the heads keep their
    init, the line is printed; a non-ResNet preset exits."""
    stages = (1, 1, 1, 1)
    gen = torch.Generator().manual_seed(1)
    sd = {}

    def conv_bn(conv, bn, cout, cin, k):
        sd[f"{conv}.weight"] = torch.randn(cout, cin, k, k, generator=gen)
        for leaf in pretrained.BN_LEAVES:
            sd[f"{bn}.{leaf}"] = torch.rand(cout, generator=gen) + 0.5

    conv_bn("conv1", "bn1", 64, 3, 7)
    cin = 64
    for s, w in enumerate((8, 16, 24, 32)):
        t = f"layer{s + 1}.0"
        for i, (cout, ci, k) in enumerate([(w, cin, 1), (w, w, 3),
                                           (4 * w, w, 1)], 1):
            conv_bn(f"{t}.conv{i}", f"{t}.bn{i}", cout, ci, k)
        conv_bn(f"{t}.downsample.0", f"{t}.downsample.1", 4 * w, cin, 1)
        cin = 4 * w
    sd["fc.weight"] = torch.randn(1000, cin, generator=gen)
    pth = str(tmp_path / "r50.pth")
    torch.save(sd, pth)
    want = pretrained.torch_resnet50_to_port(sd, stages)
    seen = {}
    graft = train.graft_pretrained

    def spy(state, path, sizes):
        head = state.model.head.cls0.weight.detach().clone()
        graft(state, path, sizes)
        seen["backbone"] = {k: v.clone() for k, v in
                            state.model.backbone.state_dict().items()}
        seen["ema"] = all(torch.equal(state.ema_params[n], p)
                          for n, p in state.model.named_parameters())
        seen["head"] = torch.equal(head, state.model.head.cls0.weight)

    train.graft_pretrained = spy
    try:
        state = train.main(["--preset", "ssd_resnet50", "--pretrained", pth,
                            "--steps", "1", "--model-dir",
                            str(tmp_path / "m"), *THIN])
    finally:
        train.graft_pretrained = graft
    assert state.step == 1
    assert all(torch.equal(seen["backbone"][k], v) for k, v in want.items())
    assert seen["ema"] and seen["head"]
    assert "grafted pretrained backbone from" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="ResNet-50"):
        train.main(["--preset", "lighthead_xception", "--pretrained", pth,
                    "--steps", "1", "--model-dir", str(tmp_path / "x"),
                    *THIN])
