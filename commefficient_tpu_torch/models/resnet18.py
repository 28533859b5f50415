"""The CIFAR ResNet18s: the post-activation BatchNorm variant and the
BN-free Fixup variant -- port of ``commefficient_tpu/models/resnet18.py``.

Both keep the reference's topology: a 3x3 prep conv, four stages of
64/128/256/256 channels at strides 1/2/2/2, and a head on the concat of
global average and max pooling (2 x 256 = 512 features). ResNet18's
norms normalize by each client's batch statistics (models/norms.py,
no tracking); it is f32 only (``--bf16`` warns), FixupResNet18 takes
``dtype``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F

from commefficient_tpu_torch.models import register_model
from commefficient_tpu_torch.models.fixup_resnet9 import (_s, conv_leaf,
                                                          scalar_leaves)
from commefficient_tpu_torch.models.layers import (Ctx, FlatModel, Leaf,
                                                   Names, conv, dense,
                                                   he_normal, zeros)
from commefficient_tpu_torch.models.norms import BatchStatNorm
from commefficient_tpu_torch.ops.vec import unravel


class PreActBlock:
    """(JAX resnet18.py:32-52): relu(bn(conv(x))) twice, plus an
    un-normalized 1x1 projection shortcut where the shape changes; no
    relu after the sum."""

    def __init__(self, cin, cout, stride, path):
        self.stride = stride
        self.project = stride != 1 or cin != cout
        self.bn0 = BatchStatNorm(cout, path + ("BatchStatNorm_0",))
        self.bn1 = BatchStatNorm(cout, path + ("BatchStatNorm_1",))
        self.leaves = {
            "Conv_0": {"kernel": Leaf((3, 3, cin, cout), he_normal)},
            "BatchStatNorm_0": self.bn0.spec(),
            "Conv_1": {"kernel": Leaf((3, 3, cout, cout), he_normal)},
            "BatchStatNorm_1": self.bn1.spec()}
        if self.project:
            self.leaves["Conv_2"] = {"kernel": Leaf((1, 1, cin, cout),
                                                    he_normal)}

    def __call__(self, p, x, ctx):
        out = conv(x, p["Conv_0"]["kernel"], self.stride, 1)
        out = F.relu(self.bn0(p["BatchStatNorm_0"], out, ctx))
        out = conv(out, p["Conv_1"]["kernel"], 1, 1)
        out = F.relu(self.bn1(p["BatchStatNorm_1"], out, ctx))
        if self.project:
            x = conv(x, p["Conv_2"]["kernel"], self.stride)
        return out + x


class FixupBlock:
    """(JAX resnet18.py:55-79): scalar adds around each conv, a scalar
    mul after conv2 (zero-init; conv1 std x L^-0.5), a 1x1 projection
    shortcut (created first, so it is ``Conv_0``), relu(out +
    shortcut)."""

    def __init__(self, cin, cout, num_layers, stride):
        self.stride = stride
        self.project = stride != 1 or cin != cout
        self.leaves = scalar_leaves("add1a", "add1b", "add2a", "add2b", "mul")
        names = Names()
        if self.project:
            self.short = names("Conv")
            self.leaves[self.short] = conv_leaf(1, cin, cout)
        self.c1 = names("Conv")
        self.leaves[self.c1] = conv_leaf(3, cin, cout, num_layers ** -0.5)
        self.c2 = names("Conv")
        self.leaves[self.c2] = conv_leaf(3, cout, cout, 0.0)

    def __call__(self, p, x):
        dt = x.dtype
        shortcut = (conv(x, p[self.short]["kernel"], self.stride)
                    if self.project else x)
        out = conv(x + _s(p, "add1a", dt), p[self.c1]["kernel"],
                   self.stride, 1)
        out = F.relu(out + _s(p, "add1b", dt))
        out = conv(out + _s(p, "add2a", dt), p[self.c2]["kernel"], 1, 1)
        out = out * _s(p, "mul", dt) + _s(p, "add2b", dt)
        return F.relu(out + shortcut)


def _avg_max_head(x):
    """Concat of global average and max pooling (NCHW -> (N, 2C))."""
    return torch.cat([torch.mean(x, dim=(2, 3)), torch.amax(x, dim=(2, 3))],
                     dim=-1)


_PLAN = (64, 128, 256, 256)
_STRIDES = (1, 2, 2, 2)


@register_model("ResNet18")
class ResNet18(FlatModel):
    """(JAX resnet18.py:89-104)."""

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 sample_shape=(32, 32, 3)):
        super().__init__()
        self.num_classes, self.dtype = num_classes, torch.float32
        self.num_blocks = tuple(num_blocks)
        cin = sample_shape[2]
        self._spec = {"Conv_0": {"kernel": Leaf((3, 3, cin, 64),
                                                he_normal)}}
        self.blocks = []
        c = 64
        for i, (c_out, stride) in enumerate(self._plan(num_blocks)):
            name = f"PreActBlock_{i}"
            blk = PreActBlock(c, c_out, stride, (name,))
            self._spec[name] = blk.leaves
            self.blocks.append((name, blk))
            c = c_out
        self._spec["Dense_0"] = {"kernel": Leaf((2 * c, num_classes),
                                                he_normal),
                                 "bias": Leaf((num_classes,), zeros)}

    @staticmethod
    def _plan(num_blocks):
        return [(c, s if b == 0 else 1)
                for c, n, s in zip(_PLAN, num_blocks, _STRIDES)
                for b in range(n)]

    def spec(self):
        return self._spec

    def forward(self, flat, x, groups=1, mask=None, running=None,
                record=None):
        p = unravel(flat, self.leaf_shapes())
        ctx = Ctx(groups, None, running, record)
        x = x.to(torch.float32).permute(0, 3, 1, 2)
        x = F.relu(conv(x, p["Conv_0"]["kernel"], 1, 1))
        for name, blk in self.blocks:
            x = blk(p[name], x, ctx)
        return dense(_avg_max_head(x), p["Dense_0"])


@register_model("FixupResNet18")
class FixupResNet18(FlatModel):
    """(JAX resnet18.py:107-129), zero-init classifier."""
    supports_bf16 = True

    def __init__(self, num_classes: int = 10,
                 num_blocks: Sequence[int] = (2, 2, 2, 2),
                 dtype=torch.float32, sample_shape=(32, 32, 3)):
        super().__init__()
        self.num_classes, self.dtype = num_classes, dtype
        self.num_blocks = tuple(num_blocks)
        L = sum(num_blocks)
        cin = sample_shape[2]
        self._spec = {"Conv_0": conv_leaf(3, cin, 64)}
        self.blocks = []
        c = 64
        for i, (c_out, stride) in enumerate(ResNet18._plan(num_blocks)):
            name = f"FixupBlock_{i}"
            blk = FixupBlock(c, c_out, L, stride)
            self._spec[name] = blk.leaves
            self.blocks.append((name, blk))
            c = c_out
        self._spec["Dense_0"] = {"kernel": Leaf((2 * c, num_classes), zeros),
                                 "bias": Leaf((num_classes,), zeros)}

    def spec(self):
        return self._spec

    def forward(self, flat, x, groups=1, mask=None, running=None,
                record=None):
        p = unravel(flat, self.leaf_shapes())
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(conv(x, p["Conv_0"]["kernel"], 1, 1))
        for name, blk in self.blocks:
            x = blk(p[name], x)
        return dense(_avg_max_head(x), p["Dense_0"]).to(torch.float32)
