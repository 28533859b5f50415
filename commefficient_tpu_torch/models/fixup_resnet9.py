"""Fixup-initialized BN-free ResNets: FixupResNet9 (CIFAR) and
FixupResNet50 (ImageNet) -- port of
``commefficient_tpu/models/fixup_resnet9.py``.

Fixup removes normalization: the residual branches' convs are
rescaled at init (first conv std x L^(-1/(2m-2)), last conv zero) and
scalar bias and scale parameters sit around each conv. The scalars are
(1,) f32 leaves applied in the compute dtype; ``dtype=torch.bfloat16``
computes in bf16 over f32 parameters, as flax's ``dtype``. Parameters
are views of the flat f32 vector in flax ravel order
(models/layers.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from commefficient_tpu_torch.models import register_model
from commefficient_tpu_torch.models.layers import (FlatModel, Leaf, Names,
                                                   conv, dense, fixup_normal,
                                                   ones, to_nhwc_flat, zeros)
from commefficient_tpu_torch.ops.vec import unravel


def scalar_leaves(*names) -> dict:
    """Fixup scalars: multiplicative (scale*, mul*) init to one,
    additive biases to zero (JAX ``_scalars``)."""
    return {n: Leaf((1,), ones if n.startswith(("scale", "mul")) else zeros)
            for n in names}


def conv_leaf(k, cin, cout, scale=1.0):
    return {"kernel": Leaf((k, k, cin, cout), fixup_normal(scale))}


def _s(p, name, dtype):
    return p[name].to(dtype)


class FixupBasicBlock:
    """Two-conv Fixup residual block (JAX fixup_resnet9.py:69-103), as
    FixupLayer uses it: stride 1, no downsample."""

    def __init__(self, cin, cout, num_layers):
        self.leaves = {
            **scalar_leaves("bias1a", "bias1b", "bias2a", "bias2b", "scale"),
            "Conv_0": conv_leaf(3, cin, cout, num_layers ** -0.5),
            "Conv_1": conv_leaf(3, cout, cout, 0.0)}

    def __call__(self, p, x):
        dt = x.dtype
        out = conv(x + _s(p, "bias1a", dt), p["Conv_0"]["kernel"], 1, 1)
        out = F.relu(out + _s(p, "bias1b", dt))
        out = conv(out + _s(p, "bias2a", dt), p["Conv_1"]["kernel"], 1, 1)
        out = out * _s(p, "scale", dt) + _s(p, "bias2b", dt)
        return F.relu(out + x)


class FixupLayer:
    """conv, bias, relu, pool, then ``num_blocks`` FixupBasicBlocks
    (JAX fixup_resnet9.py:106-128)."""

    def __init__(self, cin, cout, num_blocks, net_num_layers, pool=True):
        self.pool = pool
        self.leaves = {**scalar_leaves("bias1a", "bias1b", "scale"),
                       "Conv_0": conv_leaf(3, cin, cout)}
        self.blocks = []
        for i in range(num_blocks):
            blk = FixupBasicBlock(cout, cout, net_num_layers)
            self.leaves[f"FixupBasicBlock_{i}"] = blk.leaves
            self.blocks.append((f"FixupBasicBlock_{i}", blk))

    def __call__(self, p, x):
        dt = x.dtype
        x = conv(x + _s(p, "bias1a", dt), p["Conv_0"]["kernel"], 1, 1) \
            * _s(p, "scale", dt) + _s(p, "bias1b", dt)
        x = F.relu(x)
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        for name, blk in self.blocks:
            x = blk(p[name], x)
        return x


@register_model("FixupResNet9")
class FixupResNet9(FlatModel):
    """BN-free ResNet9 (JAX fixup_resnet9.py:131-169): prep conv, three
    FixupLayers (1/0/1 residual blocks), 4x4 max-pool, zero-init linear
    head with a scalar pre-bias."""
    supports_bf16 = True

    def __init__(self, num_classes: int = 10,
                 channels: Optional[Dict[str, int]] = None,
                 dtype=torch.float32, sample_shape=(32, 32, 3)):
        super().__init__()
        ch = channels or {"prep": 64, "layer1": 128,
                          "layer2": 256, "layer3": 512}
        self.num_classes, self.dtype = num_classes, dtype
        h, w, cin = sample_shape
        num_layers = 2  # reference fixup_resnet9.py:36
        self.layers = [
            ("FixupLayer_0", FixupLayer(ch["prep"], ch["layer1"], 1,
                                        num_layers)),
            ("FixupLayer_1", FixupLayer(ch["layer1"], ch["layer2"], 0,
                                        num_layers)),
            ("FixupLayer_2", FixupLayer(ch["layer2"], ch["layer3"], 1,
                                        num_layers))]
        h, w = h // 2 // 2 // 2 // 4, w // 2 // 2 // 2 // 4
        self._spec = {
            **scalar_leaves("bias1a", "bias1b", "scale", "bias2"),
            "Conv_0": conv_leaf(3, cin, ch["prep"]),
            **{name: layer.leaves for name, layer in self.layers},
            "Dense_0": {"kernel": Leaf((h * w * ch["layer3"], num_classes),
                                       zeros),
                        "bias": Leaf((num_classes,), zeros)}}

    @staticmethod
    def test_config(num_classes: int = 10):
        return dict(channels={"prep": 1, "layer1": 1,
                              "layer2": 1, "layer3": 1},
                    num_classes=num_classes)

    def spec(self):
        return self._spec

    def forward(self, flat, x, groups=1, mask=None, running=None,
                record=None):
        p = unravel(flat, self.leaf_shapes())
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        out = conv(x + _s(p, "bias1a", dt), p["Conv_0"]["kernel"], 1, 1) \
            * _s(p, "scale", dt) + _s(p, "bias1b", dt)
        out = F.relu(out)
        for name, layer in self.layers:
            out = layer(p[name], out)
        out = to_nhwc_flat(F.max_pool2d(out, 4, 4))
        out = dense(out + _s(p, "bias2", dt), p["Dense_0"])
        return out.to(torch.float32)


class FixupBottleneck:
    """Three-conv Fixup bottleneck (JAX fixup_resnet9.py:172-207):
    conv1/conv2 std x L^-0.25, conv3 zero-init, projection shortcut a
    1x1 conv on (x + bias1a)."""
    expansion = 4

    def __init__(self, cin, planes, num_layers, stride=1, project=False):
        self.stride, self.project = stride, project
        s = num_layers ** -0.25
        self.leaves = {
            **scalar_leaves("bias1a", "bias1b", "bias2a", "bias2b",
                            "bias3a", "bias3b", "scale"),
            "Conv_0": conv_leaf(1, cin, planes, s),
            "Conv_1": conv_leaf(3, planes, planes, s),
            "Conv_2": conv_leaf(1, planes, planes * self.expansion, 0.0)}
        if project:
            self.leaves["Conv_3"] = conv_leaf(1, cin,
                                              planes * self.expansion)

    def __call__(self, p, x):
        dt = x.dtype
        b1a = _s(p, "bias1a", dt)
        out = conv(x + b1a, p["Conv_0"]["kernel"])
        out = F.relu(out + _s(p, "bias1b", dt))
        out = conv(out + _s(p, "bias2a", dt), p["Conv_1"]["kernel"],
                   self.stride, 1)
        out = F.relu(out + _s(p, "bias2b", dt))
        out = conv(out + _s(p, "bias3a", dt), p["Conv_2"]["kernel"])
        out = out * _s(p, "scale", dt) + _s(p, "bias3b", dt)
        identity = (conv(x + b1a, p["Conv_3"]["kernel"], self.stride)
                    if self.project else x)
        return F.relu(out + identity)


@register_model("FixupResNet50")
class FixupResNet50(FlatModel):
    """Fixup ImageNet ResNet-50 (JAX fixup_resnet9.py:210-245): 7x7/2
    stem with scalar bias, 3x3/2 max-pool, four stages of
    FixupBottlenecks, global average pool, zero-init fc."""
    supports_bf16 = True

    def __init__(self, num_classes: int = 1000,
                 stage_sizes: Sequence[int] = (3, 4, 6, 3),
                 dtype=torch.float32, sample_shape=(224, 224, 3)):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.stage_sizes = tuple(stage_sizes)
        L = sum(stage_sizes)
        cin = sample_shape[2]
        self._spec = {**scalar_leaves("bias1", "bias2"),
                      "Conv_0": conv_leaf(7, cin, 64)}
        self.blocks = []
        names = Names()
        planes, in_ch = 64, 64
        for stage, n_blocks in enumerate(stage_sizes):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                s = stride if b == 0 else 1
                blk = FixupBottleneck(
                    in_ch, planes, L, s,
                    project=(b == 0 and (stride != 1
                                         or in_ch != planes * 4)))
                name = names("FixupBottleneck")
                self._spec[name] = blk.leaves
                self.blocks.append((name, blk))
                in_ch = planes * 4
            planes *= 2
        self._spec["Dense_0"] = {"kernel": Leaf((in_ch, num_classes), zeros),
                                 "bias": Leaf((num_classes,), zeros)}

    def spec(self):
        return self._spec

    def forward(self, flat, x, groups=1, mask=None, running=None,
                record=None):
        p = unravel(flat, self.leaf_shapes())
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        x = F.relu(conv(x, p["Conv_0"]["kernel"], 2, 3) + _s(p, "bias1", dt))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, blk in self.blocks:
            x = blk(p[name], x)
        x = torch.mean(x, dim=(2, 3))
        x = dense(x + _s(p, "bias2", dt), p["Dense_0"])
        return x.to(torch.float32)
