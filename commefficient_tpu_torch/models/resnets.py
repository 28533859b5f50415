"""The generic ResNet family (resnet18 ... wide_resnet101_2) and
ResNet101LN -- port of ``commefficient_tpu/models/resnets.py``.

The stem conv takes the image's channels (1 for 28 x 28 grayscale
EMNIST), every norm site is ``BatchStatNorm`` (``norm="batch"``,
statistics per client, no tracking) or ``LayerNorm`` over (H, W, C)
(``norm="layer"``), and ``ResNet101LN`` is resnet101 with LayerNorm
and 62 classes. The LayerNorm shapes follow from ``sample_shape``
(H, W, C), as flax resolves them from the init input. Parameters are
views of the flat f32 vector in flax ravel order (models/layers.py);
f32 only, as in the JAX package (no ``dtype`` field: ``--bf16`` warns
and trains in f32).
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from commefficient_tpu_torch.models import register_model
from commefficient_tpu_torch.models.layers import (Ctx, FlatModel, Leaf,
                                                   Names, conv, dense,
                                                   he_normal, out_size,
                                                   zeros)
from commefficient_tpu_torch.models.norms import BatchStatNorm, LayerNorm
from commefficient_tpu_torch.ops.vec import unravel


def _norm(kind: str, names: Names, path: tuple, hwc: tuple):
    """(flax name, norm site) for an activation of shape ``hwc``."""
    if kind == "batch":
        name = names("BatchStatNorm")
        return name, BatchStatNorm(hwc[2], path + (name,))
    if kind == "layer":
        return names("LayerNorm"), LayerNorm(hwc)
    raise ValueError(f"unknown norm {kind!r}")


class _Block:
    """A residual block as a list of named convs and norms; ``hw`` is
    its input's spatial size, ``out_hw`` its output's."""

    def _conv(self, names, k, cin, cout, groups=1):
        name = names("Conv")
        self.leaves[name] = {"kernel": Leaf((k, k, cin // groups, cout),
                                            he_normal)}
        return name

    def _norm(self, names, hwc):
        name, site = _norm(self.norm, names, self.path, hwc)
        self.leaves[name] = site.spec()
        self.norms[name] = site
        return name

    def spec(self):
        return self.leaves


class BasicBlock(_Block):
    """(JAX resnets.py:41-64)."""
    expansion = 1

    def __init__(self, cin, planes, norm, stride, hw, path):
        self.norm, self.path, self.stride = norm, tuple(path), stride
        self.leaves, self.norms = {}, {}
        names = Names()
        h, w = (out_size(n, 3, stride, 1) for n in hw)
        self.c0 = self._conv(names, 3, cin, planes)
        self.n0 = self._norm(names, (h, w, planes))
        self.c1 = self._conv(names, 3, planes, planes)
        self.n1 = self._norm(names, (h, w, planes))
        self.down = stride != 1 or cin != planes
        if self.down:
            self.c2 = self._conv(names, 1, cin, planes)
            self.n2 = self._norm(names, (h, w, planes))
        self.out_hw, self.out_c = (h, w), planes

    def __call__(self, p, x, ctx):
        out = conv(x, p[self.c0]["kernel"], self.stride, 1)
        out = F.relu(self.norms[self.n0](p[self.n0], out, ctx))
        out = conv(out, p[self.c1]["kernel"], 1, 1)
        out = self.norms[self.n1](p[self.n1], out, ctx)
        if self.down:
            x = self.norms[self.n2](
                p[self.n2], conv(x, p[self.c2]["kernel"], self.stride), ctx)
        return F.relu(out + x)


class Bottleneck(_Block):
    """(JAX resnets.py:67-96), with ``groups`` and ``base_width``."""
    expansion = 4

    def __init__(self, cin, planes, norm, stride, hw, path, base_width=64,
                 groups=1):
        self.norm, self.path, self.stride = norm, tuple(path), stride
        self.groups = groups
        self.leaves, self.norms = {}, {}
        names = Names()
        width = int(planes * (base_width / 64.0)) * groups
        out_ch = planes * self.expansion
        h1, w1 = (out_size(n, 3, stride, 1) for n in hw)
        self.c0 = self._conv(names, 1, cin, width)
        self.n0 = self._norm(names, tuple(hw) + (width,))
        self.c1 = self._conv(names, 3, width, width, groups)
        self.n1 = self._norm(names, (h1, w1, width))
        self.c2 = self._conv(names, 1, width, out_ch)
        self.n2 = self._norm(names, (h1, w1, out_ch))
        self.down = stride != 1 or cin != out_ch
        if self.down:
            self.c3 = self._conv(names, 1, cin, out_ch)
            self.n3 = self._norm(names, (h1, w1, out_ch))
        self.out_hw, self.out_c = (h1, w1), out_ch

    def __call__(self, p, x, ctx):
        out = conv(x, p[self.c0]["kernel"])
        out = F.relu(self.norms[self.n0](p[self.n0], out, ctx))
        out = conv(out, p[self.c1]["kernel"], self.stride, 1, self.groups)
        out = F.relu(self.norms[self.n1](p[self.n1], out, ctx))
        out = conv(out, p[self.c2]["kernel"])
        out = self.norms[self.n2](p[self.n2], out, ctx)
        if self.down:
            x = self.norms[self.n3](
                p[self.n3], conv(x, p[self.c3]["kernel"], self.stride), ctx)
        return F.relu(out + x)


class ResNet(FlatModel):
    """(JAX resnets.py:99-128): 7x7/2 stem, 3x3/2 max-pool, four
    stages, global average pool, fc with bias."""

    def __init__(self, block, layers: Sequence[int], num_classes: int = 1000,
                 norm: str = "batch", width_per_group: int = 64,
                 groups: int = 1, sample_shape=(28, 28, 1)):
        super().__init__()
        self.num_classes, self.norm = num_classes, norm
        self.block, self.layers = block, tuple(layers)
        self.dtype = torch.float32
        h, w, cin = sample_shape
        names = Names()
        self._spec, self.norms = {}, {}
        self.c0 = names("Conv")
        self._spec[self.c0] = {"kernel": Leaf((7, 7, cin, 64), he_normal)}
        h, w = out_size(h, 7, 2, 3), out_size(w, 7, 2, 3)
        self.n0, site = _norm(norm, names, (), (h, w, 64))
        self._spec[self.n0], self.norms[self.n0] = site.spec(), site
        h, w = out_size(h, 3, 2, 1), out_size(w, 3, 2, 1)
        self.blocks = []
        planes, c = 64, 64
        for stage, n_blocks in enumerate(layers):
            stride = 1 if stage == 0 else 2
            for b in range(n_blocks):
                name = names(block.__name__)
                kw = ({"base_width": width_per_group, "groups": groups}
                      if block is Bottleneck else {})
                blk = block(c, planes, norm, stride if b == 0 else 1,
                            (h, w), (name,), **kw)
                self._spec[name] = blk.spec()
                self.blocks.append((name, blk))
                (h, w), c = blk.out_hw, blk.out_c
            planes *= 2
        self.fc = names("Dense")
        self._spec[self.fc] = {"bias": Leaf((num_classes,), zeros),
                               "kernel": Leaf((c, num_classes), he_normal)}

    def spec(self):
        return self._spec

    def forward(self, flat, x, groups=1, mask=None, running=None,
                record=None):
        p = unravel(flat, self.leaf_shapes())
        ctx = Ctx(groups, mask, running, record)
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        x = conv(x, p[self.c0]["kernel"], 2, 3)
        x = F.relu(self.norms[self.n0](p[self.n0], x, ctx))
        x = F.max_pool2d(x, 3, 2, 1)
        for name, blk in self.blocks:
            x = blk(p[name], x, ctx)
        x = torch.mean(x, dim=(2, 3))
        return dense(x, p[self.fc])


def _factory(name, layers, block, **preset):
    def make(**kwargs):
        return ResNet(block=block, layers=layers, **{**preset, **kwargs})
    make.__name__ = name
    return register_model(name)(make)


# the JAX package's factory surface (resnets.py:140-153)
resnet18 = _factory("resnet18", [2, 2, 2, 2], BasicBlock)
resnet34 = _factory("resnet34", [3, 4, 6, 3], BasicBlock)
resnet50 = _factory("resnet50", [3, 4, 6, 3], Bottleneck)
resnet101 = _factory("resnet101", [3, 4, 23, 3], Bottleneck)
resnet152 = _factory("resnet152", [3, 8, 36, 3], Bottleneck)
resnext50_32x4d = _factory("resnext50_32x4d", [3, 4, 6, 3], Bottleneck,
                           groups=32, width_per_group=4)
resnext101_32x8d = _factory("resnext101_32x8d", [3, 4, 23, 3], Bottleneck,
                            groups=32, width_per_group=8)
wide_resnet50_2 = _factory("wide_resnet50_2", [3, 4, 6, 3], Bottleneck,
                           width_per_group=128)
wide_resnet101_2 = _factory("wide_resnet101_2", [3, 4, 23, 3], Bottleneck,
                            width_per_group=128)


@register_model("ResNet101LN")
def ResNet101LN(num_classes: int = 62, **kwargs) -> ResNet:
    """resnet101 with LayerNorm, 62 classes (EMNIST byclass)."""
    return resnet101(num_classes=num_classes, norm="layer", **kwargs)
