"""Torch-format CV export (models/torch_export.py): reference key
names, correct tensor layouts, lossless round-trip. The image has no
torchvision, so layout correctness is proven op-by-op against torch
functional ops and structurally by schema + round-trip."""

import torch_threads  # noqa: F401  (the worker's share of the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from commefficient_tpu.models import get_model
from commefficient_tpu.models.torch_export import (build_name_map,
                                                   cv_load_state_dict,
                                                   cv_state_dict,
                                                   supports_torch_export)


def _init(module, shape=(1, 32, 32, 3)):
    return module.init(jax.random.PRNGKey(0),
                       jnp.zeros(shape))["params"]


class TestLayouts:
    """Exported tensors compute the same op in torch."""

    def test_conv_kernel_layout(self):
        import flax.linen as nn
        conv = nn.Conv(4, (3, 3), padding=1, use_bias=False)
        x = np.random.RandomState(0).randn(2, 8, 8, 3).astype(
            np.float32)
        params = conv.init(jax.random.PRNGKey(1),
                           jnp.asarray(x))["params"]
        want = np.asarray(conv.apply({"params": params},
                                     jnp.asarray(x)))
        w = np.transpose(np.asarray(params["kernel"]), (3, 2, 0, 1))
        got = torch.nn.functional.conv2d(
            torch.from_numpy(np.transpose(x, (0, 3, 1, 2))),
            torch.from_numpy(w), padding=1).numpy()
        np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)),
                                   want, rtol=1e-4, atol=1e-5)

    def test_dense_kernel_layout(self):
        import flax.linen as nn
        dense = nn.Dense(5)
        x = np.random.RandomState(0).randn(3, 7).astype(np.float32)
        params = dense.init(jax.random.PRNGKey(1),
                            jnp.asarray(x))["params"]
        want = np.asarray(dense.apply({"params": params},
                                      jnp.asarray(x)))
        got = torch.nn.functional.linear(
            torch.from_numpy(x),
            torch.from_numpy(np.asarray(params["kernel"]).T),
            torch.from_numpy(np.asarray(params["bias"]))).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_layernorm_affine_layout(self):
        """flax LN over (H, W, C) == torch LayerNorm((C, h, w)) on the
        channels-first activation (the reference resnets fork's LN
        sites, resnets.py:79-97)."""
        import flax.linen as nn
        ln = nn.LayerNorm(reduction_axes=(-3, -2, -1),
                          feature_axes=(-3, -2, -1))
        rng = np.random.RandomState(2)
        x = rng.randn(2, 4, 4, 3).astype(np.float32)
        params = ln.init(jax.random.PRNGKey(1),
                         jnp.asarray(x))["params"]
        # non-trivial affine
        params = {"scale": jnp.asarray(
                      rng.randn(4, 4, 3).astype(np.float32)),
                  "bias": jnp.asarray(
                      rng.randn(4, 4, 3).astype(np.float32))}
        want = np.asarray(ln.apply({"params": params},
                                   jnp.asarray(x)))
        tln = torch.nn.LayerNorm((3, 4, 4))
        with torch.no_grad():
            tln.weight.copy_(torch.from_numpy(np.transpose(
                np.asarray(params["scale"]), (2, 0, 1))))
            tln.bias.copy_(torch.from_numpy(np.transpose(
                np.asarray(params["bias"]), (2, 0, 1))))
            got = tln(torch.from_numpy(
                np.transpose(x, (0, 3, 1, 2)))).numpy()
        np.testing.assert_allclose(np.transpose(got, (0, 2, 3, 1)),
                                   want, rtol=1e-4, atol=1e-4)


class TestSchemas:
    """Exported key sets match the reference torch modules' names."""

    def test_resnet9_keys(self):
        module = get_model("ResNet9")(
            num_classes=10, channels={"prep": 2, "layer1": 2,
                                      "layer2": 2, "layer3": 2})
        sd = cv_state_dict(module, _init(module))
        want = {f"n.{m}.conv.weight" for m in
                ("prep", "layer1", "layer2", "layer3",
                 "res1.res1", "res1.res2", "res3.res1", "res3.res2")}
        want.add("n.linear.weight")
        assert set(sd) == want  # reference resnet9.py:74-124
        assert sd["n.prep.conv.weight"].shape == (2, 3, 3, 3)
        # head input = layer3 channels x 2x2 remaining spatial
        assert sd["n.linear.weight"].shape == (10, 8)

    def test_resnet9_batchnorm_keys_and_stats(self):
        module = get_model("ResNet9")(
            num_classes=10, do_batchnorm=True,
            channels={"prep": 2, "layer1": 2, "layer2": 2,
                      "layer3": 2})
        variables = module.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3)))
        params, stats = variables["params"], variables["batch_stats"]
        sd = cv_state_dict(module, params, stats)
        for site in ("n.prep.bn", "n.res1.res1.bn"):
            for leaf in ("weight", "bias", "running_mean",
                         "running_var", "num_batches_tracked"):
                assert f"{site}.{leaf}" in sd, site + "." + leaf
        assert sd["n.prep.bn.running_var"].shape == (2,)
        assert sd["n.prep.bn.num_batches_tracked"].dtype == np.int64

    def test_fixup_resnet9_keys(self):
        module = get_model("FixupResNet9")(
            channels={"prep": 2, "layer1": 2, "layer2": 2,
                      "layer3": 2})
        sd = cv_state_dict(module, _init(module))
        # reference fixup_resnet9.py:33-56 naming
        for k in ("conv1.weight", "bias1a", "bias1b", "scale",
                  "bias2", "linear.weight", "linear.bias",
                  "layer1.conv.weight", "layer1.bias1a",
                  "layer1.blocks.0.conv1.weight",
                  "layer1.blocks.0.bias2b",
                  "layer2.conv.weight", "layer3.blocks.0.scale"):
            assert k in sd, k
        # layer2 has 0 residual blocks (reference plan 1/0/1)
        assert not any(k.startswith("layer2.blocks") for k in sd)

    def test_fixup_resnet50_keys(self):
        module = get_model("FixupResNet50")(num_classes=3,
                                            stage_sizes=(1, 1, 1, 1))
        sd = cv_state_dict(module, _init(module, (1, 64, 64, 3)))
        for k in ("conv1.weight", "bias1", "bias2", "fc.weight",
                  "fc.bias", "layer1.0.conv1.weight",
                  "layer1.0.conv3.weight", "layer1.0.downsample.weight",
                  "layer4.0.conv2.weight", "layer4.0.bias3b"):
            assert k in sd, k

    def test_resnet18_families_keys(self):
        m1 = get_model("ResNet18")(num_classes=10,
                                   num_blocks=(1, 1, 1, 1))
        # batch-stat BN (no tracked stats): identity running buffers
        # are synthesized so the artifact strict-loads in torch
        sd = cv_state_dict(m1, _init(m1))
        # reference fixup_resnet18.py:168-216: prep Sequential, flat
        # ``layers`` over all blocks, avg+max head -> classifier
        for k in ("prep.0.weight", "layers.0.conv1.weight",
                  "layers.0.bn1.weight", "layers.0.bn1.running_mean",
                  "layers.1.shortcut.0.weight", "classifier.weight",
                  "classifier.bias"):
            assert k in sd, k
        assert not any(k.startswith("layers.0.shortcut")
                       for k in sd)  # stride-1 same-width: no proj

        m2 = get_model("FixupResNet18")(num_classes=10,
                                        num_blocks=(1, 1, 1, 1))
        sd2 = cv_state_dict(m2, _init(m2))
        for k in ("prep.weight", "layers.0.conv1.weight",
                  "layers.0.add1a.bias", "layers.0.mul.scale",
                  "layers.1.shortcut.weight", "classifier.weight"):
            assert k in sd2, k

    def test_resnets_family_keys(self):
        from commefficient_tpu.models.resnets import (BasicBlock,
                                                      Bottleneck,
                                                      ResNet)
        m = ResNet(block=BasicBlock, layers=(1, 1, 1, 1),
                   num_classes=5, norm="batch")
        sd = cv_state_dict(m, _init(m, (1, 28, 28, 1)))
        # torchvision naming (the reference forked it, resnets.py)
        for k in ("conv1.weight", "bn1.weight", "bn1.running_mean",
                  "layer1.0.conv1.weight", "layer1.0.bn2.weight",
                  "layer2.0.downsample.0.weight",
                  "layer2.0.downsample.1.running_var", "fc.weight",
                  "fc.bias"):
            assert k in sd, k
        assert sd["conv1.weight"].shape == (64, 1, 7, 7)

        ml = ResNet(block=Bottleneck, layers=(1, 1, 1, 1),
                    num_classes=5, norm="layer")
        sd = cv_state_dict(ml, _init(ml, (1, 28, 28, 1)))
        for k in ("bn1.weight", "layer1.0.bn3.bias",
                  "layer1.0.downsample.1.weight"):
            assert k in sd, k
        assert not any("running" in k for k in sd)  # LN: no stats


class TestRoundTrip:
    """Export -> torch.save -> torch.load -> import into a different
    init == original forward. Proves the name map bijective and every
    layout transform self-inverse-consistent."""

    @pytest.mark.parametrize("name,kw,shape", [
        ("ResNet9", dict(channels={"prep": 2, "layer1": 2,
                                   "layer2": 2, "layer3": 2}), 32),
        ("FixupResNet9", dict(channels={"prep": 2, "layer1": 2,
                                        "layer2": 2, "layer3": 2}), 32),
        ("FixupResNet18", dict(num_blocks=(1, 1, 1, 1)), 32),
    ])
    def test_roundtrip_forward(self, tmp_path, name, kw, shape):
        module = get_model(name)(num_classes=10, **kw)
        x = jnp.asarray(np.random.RandomState(0).randn(
            2, shape, shape, 3).astype(np.float32))
        p_src = module.init(jax.random.PRNGKey(0), x)["params"]
        p_dst = module.init(jax.random.PRNGKey(7), x)["params"]
        want = np.asarray(module.apply({"params": p_src}, x))

        sd = cv_state_dict(module, p_src)
        path = tmp_path / "m.pt"
        torch.save({k: torch.from_numpy(np.array(v, copy=True))
                    for k, v in sd.items()}, str(path))
        loaded = {k: v.numpy()
                  for k, v in torch.load(str(path)).items()}
        p_back = cv_load_state_dict(module, p_dst, loaded)
        got = np.asarray(module.apply({"params": p_back}, x))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)

    def test_roundtrip_with_batch_stats(self, tmp_path):
        module = get_model("ResNet9")(
            num_classes=10, do_batchnorm=True,
            channels={"prep": 2, "layer1": 2, "layer2": 2,
                      "layer3": 2})
        x = jnp.asarray(np.random.RandomState(3).randn(
            2, 32, 32, 3).astype(np.float32))
        v = module.init(jax.random.PRNGKey(0), x)
        p_src, s_src = v["params"], v["batch_stats"]
        # non-trivial running stats
        s_src = jax.tree_util.tree_map(
            lambda a: a + np.random.RandomState(5).rand(
                *a.shape).astype(np.float32), s_src)
        want = np.asarray(module.apply(
            {"params": p_src, "batch_stats": s_src}, x, train=False))

        sd = cv_state_dict(module, p_src, s_src)
        v2 = module.init(jax.random.PRNGKey(9), x)
        p_back, s_back = cv_load_state_dict(module, v2["params"], sd,
                                            v2["batch_stats"])
        got = np.asarray(module.apply(
            {"params": p_back, "batch_stats": s_back}, x,
            train=False))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_fed_model_save_pretrained_torch_format(tmp_path):
    """FedModel.save_pretrained(..., torch_format=True) writes the
    reference's artifact (state_dict.pt) next to the flax blob."""
    from commefficient_tpu.config import Config
    from commefficient_tpu.runtime import FedModel
    from commefficient_tpu.train.cv_train import make_compute_loss

    module = get_model("ResNet9")(
        num_classes=10, channels={"prep": 1, "layer1": 1,
                                  "layer2": 1, "layer3": 1})
    params = _init(module)
    args = Config(mode="uncompressed", error_type="none",
                  local_momentum=0.0, num_workers=1,
                  local_batch_size=2, num_clients=2,
                  dataset_name="CIFAR10", k=10, seed=0)
    model = FedModel(module, params, make_compute_loss(module), args)
    model.save_pretrained(str(tmp_path), torch_format=True)
    sd = torch.load(str(tmp_path / "state_dict.pt"))
    assert "n.prep.conv.weight" in sd
    np.testing.assert_allclose(
        sd["n.linear.weight"].numpy(),
        np.asarray(model.params()["Dense_0"]["kernel"]).T)


def test_supports_torch_export():
    assert supports_torch_export(get_model("ResNet9")())
    assert not supports_torch_export(object())
