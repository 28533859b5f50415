"""ResNet9 -- the cifar10_fast-style 9-layer ResNet (default CV model).

Port of ``commefficient_tpu/models/resnet9.py``: ConvBN blocks (3x3
conv, optional ``--batchnorm`` norm, ReLU, optional 2x2 max-pool), two
residual blocks, a bias-free linear head scaled by 0.125.

The parameters are NOT registered on the module: ``forward(flat, x)``
takes the flat f32 vector (``ops/vec.py``, ravel_pytree order) and
views it as the flax leaves, HWIO conv kernels and an (in, out) dense
kernel, transposed to PyTorch's layouts at use. Autograd through the
views returns the gradient already in flat JAX order. Inputs are NHWC
like the reference's; the convolutions run NCHW, so the head permutes
back to NHWC before flattening the final 2x2 pool (the reference
flattens (N, 2, 2, C)).

``dtype=torch.bfloat16`` computes in bf16 over the f32 parameters, as
flax's ``dtype=bfloat16``; the logits come back in f32.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from commefficient_tpu_torch.models import register_model
from commefficient_tpu_torch.models.layers import (Ctx, FlatModel, Leaf,
                                                   conv, he_normal,
                                                   to_nhwc_flat)
from commefficient_tpu_torch.models.norms import BatchStatNorm
from commefficient_tpu_torch.ops.vec import unravel


class ConvBN:
    """3x3 conv (no bias), with ``do_batchnorm`` a tracking
    ``BatchStatNorm``, ReLU, optional 2x2 max-pool (reference
    resnet9.py:34-61)."""

    def __init__(self, c_in: int, c_out: int, path: tuple,
                 pool: bool = False, do_batchnorm: bool = False):
        self.pool = pool
        self.leaves = {"Conv_0": {"kernel": Leaf((3, 3, c_in, c_out),
                                                 he_normal)}}
        self.norm = None
        if do_batchnorm:
            self.norm = BatchStatNorm(c_out, tuple(path)
                                      + ("BatchStatNorm_0",),
                                      track_stats=True)
            self.leaves["BatchStatNorm_0"] = self.norm.spec()

    def state_spec(self):
        return ({"BatchStatNorm_0": self.norm.state_spec()}
                if self.norm else {})

    def __call__(self, p, x, ctx):
        x = conv(x, p["Conv_0"]["kernel"], 1, 1)
        if self.norm is not None:
            x = self.norm(p["BatchStatNorm_0"], x, ctx)
        x = F.relu(x)
        if self.pool:
            x = F.max_pool2d(x, 2, 2)
        return x


class Residual:
    """x + relu(ConvBN(ConvBN(x))) (reference resnet9.py:64-76)."""

    def __init__(self, c: int, path: tuple, do_batchnorm: bool = False):
        self.convs = [ConvBN(c, c, tuple(path) + (f"ConvBN_{i}",),
                             do_batchnorm=do_batchnorm) for i in range(2)]
        self.leaves = {f"ConvBN_{i}": cb.leaves
                       for i, cb in enumerate(self.convs)}

    def state_spec(self):
        return {f"ConvBN_{i}": cb.state_spec()
                for i, cb in enumerate(self.convs) if cb.norm}

    def __call__(self, p, x, ctx):
        y = x
        for i, cb in enumerate(self.convs):
            y = cb(p[f"ConvBN_{i}"], y, ctx)
        return x + F.relu(y)


@register_model("ResNet9")
class ResNet9(FlatModel):
    """(reference resnet9.py:79-119). Submodules carry the flax names
    (``ConvBN_0`` ... ``Dense_0``), so the leaf paths are the flax
    parameter paths. With ``do_batchnorm`` each ConvBN's norm trains on
    its client's masked batch statistics and records them
    (``record``); eval normalizes by the server's running statistics
    (``running``)."""
    supports_bf16 = True

    def __init__(self, num_classes: int = 10, do_batchnorm: bool = False,
                 channels: Optional[Dict[str, int]] = None,
                 weight: float = 0.125, dtype=torch.float32,
                 sample_shape=(32, 32, 3)):
        super().__init__()
        ch = channels or {"prep": 64, "layer1": 128,
                          "layer2": 256, "layer3": 512}
        self.num_classes, self.weight, self.dtype = num_classes, weight, dtype
        h, w, c_in = sample_shape
        bn = do_batchnorm
        self.stages = [
            ("ConvBN_0", ConvBN(c_in, ch["prep"], ("ConvBN_0",),
                                do_batchnorm=bn)),
            ("ConvBN_1", ConvBN(ch["prep"], ch["layer1"], ("ConvBN_1",),
                                pool=True, do_batchnorm=bn)),
            ("Residual_0", Residual(ch["layer1"], ("Residual_0",), bn)),
            ("ConvBN_2", ConvBN(ch["layer1"], ch["layer2"], ("ConvBN_2",),
                                pool=True, do_batchnorm=bn)),
            ("ConvBN_3", ConvBN(ch["layer2"], ch["layer3"], ("ConvBN_3",),
                                pool=True, do_batchnorm=bn)),
            ("Residual_1", Residual(ch["layer3"], ("Residual_1",), bn))]
        # three pools and the head's pool: a 32x32 input is 2x2
        self.head_in = ch["layer3"] * (h // 16) * (w // 16)
        self._spec = {name: st.leaves for name, st in self.stages}
        self._spec["Dense_0"] = {"kernel": Leaf((self.head_in, num_classes),
                                                he_normal)}

    @staticmethod
    def test_config(num_classes: int = 10):
        """--test shrink: 1 channel per layer (reference
        cv_train.py:329-336)."""
        return dict(channels={"prep": 1, "layer1": 1,
                              "layer2": 1, "layer3": 1},
                    num_classes=num_classes)

    def spec(self):
        return self._spec

    def state_spec(self):
        out = {name: st.state_spec() for name, st in self.stages}
        return {k: v for k, v in out.items() if v}

    def forward(self, flat: torch.Tensor, x: torch.Tensor, groups=1,
                mask=None, running=None, record=None) -> torch.Tensor:
        """flat (d,) f32 parameters, x (N, H, W, C) images -> (N,
        num_classes) f32 logits."""
        p = unravel(flat, self.leaf_shapes())
        ctx = Ctx(groups, mask, running, record)
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        for name, st in self.stages:
            x = st(p[name], x, ctx)
        x = to_nhwc_flat(F.max_pool2d(x, 2, 2))
        x = x @ p["Dense_0"]["kernel"].to(x.dtype)
        return (x * self.weight).to(torch.float32)
