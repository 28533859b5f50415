"""ResNet9 -- the cifar10_fast-style 9-layer ResNet (default CV model).

Port of ``commefficient_tpu/models/resnet9.py`` (BN-free default):
ConvBN blocks (3x3 conv, ReLU, optional 2x2 max-pool), two residual
blocks, a bias-free linear head scaled by 0.125.

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

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.models import register_model
from commefficient_tpu_torch.ops.vec import (flat_size, flatten_params,
                                             ravel_order, unravel)

# flax layout -> torch layout (the reference's models/torch_export.py
# _TRANSFORMS, export direction)
_CONV_TO_TORCH = (3, 2, 0, 1)  # (kh, kw, cin, cout) -> (cout, cin, kh, kw)


def _conv(x, kernel):
    return F.conv2d(x, kernel.to(x.dtype).permute(*_CONV_TO_TORCH),
                    padding=1)


class ConvBN(nn.Module):
    """3x3 conv (no bias), ReLU, optional 2x2 max-pool (reference
    resnet9.py:34-61, BN-free)."""

    def __init__(self, c_in: int, c_out: int, pool: bool = False):
        super().__init__()
        self.c_in, self.c_out, self.pool = c_in, c_out, pool

    def leaf_shapes(self):
        return {"Conv_0": {"kernel": (3, 3, self.c_in, self.c_out)}}

    def forward(self, p, x):
        x = F.relu(_conv(x, p["Conv_0"]["kernel"]))
        if self.pool:
            x = F.max_pool2d(x, 2)
        return x


class Residual(nn.Module):
    """x + relu(ConvBN(ConvBN(x))) (reference resnet9.py:64-76)."""

    def __init__(self, c: int):
        super().__init__()
        self.ConvBN_0 = ConvBN(c, c)
        self.ConvBN_1 = ConvBN(c, c)

    def leaf_shapes(self):
        return {"ConvBN_0": self.ConvBN_0.leaf_shapes(),
                "ConvBN_1": self.ConvBN_1.leaf_shapes()}

    def forward(self, p, x):
        y = self.ConvBN_1(p["ConvBN_1"], self.ConvBN_0(p["ConvBN_0"], x))
        return x + F.relu(y)


@register_model("ResNet9")
class ResNet9(nn.Module):
    """(reference resnet9.py:79-119). Submodules carry the flax names
    (``ConvBN_0`` ... ``Dense_0``), so the leaf paths are the flax
    parameter paths."""

    def __init__(self, num_classes: int = 10, do_batchnorm: bool = False,
                 initial_channels: int = 3,
                 channels: Optional[Dict[str, int]] = None,
                 weight: float = 0.125, dtype=torch.float32):
        super().__init__()
        if do_batchnorm:
            raise NotImplementedError("--batchnorm is not ported")
        ch = channels or {"prep": 64, "layer1": 128,
                          "layer2": 256, "layer3": 512}
        self.num_classes, self.weight, self.dtype = num_classes, weight, dtype
        self.ConvBN_0 = ConvBN(initial_channels, ch["prep"])
        self.ConvBN_1 = ConvBN(ch["prep"], ch["layer1"], pool=True)
        self.Residual_0 = Residual(ch["layer1"])
        self.ConvBN_2 = ConvBN(ch["layer1"], ch["layer2"], pool=True)
        self.ConvBN_3 = ConvBN(ch["layer2"], ch["layer3"], pool=True)
        self.Residual_1 = Residual(ch["layer3"])
        # after three pools and the head's pool a 32x32 input is 2x2
        self.head_in = ch["layer3"] * 2 * 2

    @staticmethod
    def test_config(num_classes: int = 10):
        """--test shrink: 1 channel per layer (reference
        cv_train.py:329-336)."""
        return dict(channels={"prep": 1, "layer1": 1,
                              "layer2": 1, "layer3": 1},
                    num_classes=num_classes)

    def leaf_shapes(self):
        return {
            "ConvBN_0": self.ConvBN_0.leaf_shapes(),
            "ConvBN_1": self.ConvBN_1.leaf_shapes(),
            "Residual_0": self.Residual_0.leaf_shapes(),
            "ConvBN_2": self.ConvBN_2.leaf_shapes(),
            "ConvBN_3": self.ConvBN_3.leaf_shapes(),
            "Residual_1": self.Residual_1.leaf_shapes(),
            "Dense_0": {"kernel": (self.head_in, self.num_classes)},
        }

    @property
    def num_params(self) -> int:
        return flat_size(self.leaf_shapes())

    def init_flat(self, seed: int, device="cpu") -> torch.Tensor:
        """Random flat parameters from ``seed``: flax's he_normal
        (variance 2/fan_in, normal truncated at two std devs) for every
        kernel, drawn on the CPU from a seeded generator. The draws
        differ from jax.random's; tests carry JAX weights over with
        ``from_jax_params`` instead."""
        gen = torch.Generator().manual_seed(int(seed))
        parts = []
        for _, shape in ravel_order(self.leaf_shapes()):
            fan_in = int(np.prod(shape[:-1]))
            std = math.sqrt(2.0 / fan_in) / .87962566103423978
            w = torch.empty(shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=gen)
            parts.append(w.reshape(-1))
        return torch.cat(parts).to(device)

    def from_jax_params(self, params_np: dict, device="cpu") -> torch.Tensor:
        """The JAX package's flax parameter tree, as numpy arrays ->
        the port's flat vector (bit-identical to ravel_pytree)."""
        want = [(p, tuple(s)) for p, s in ravel_order(self.leaf_shapes())]
        got = [(p, tuple(np.shape(a))) for p, a in ravel_order(params_np)]
        if want != got:
            raise ValueError(f"parameter tree mismatch: {got} != {want}")
        return flatten_params(params_np, device)

    def forward(self, flat: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """flat (d,) f32 parameters, x (N, H, W, C) images -> (N,
        num_classes) f32 logits."""
        p = unravel(flat, self.leaf_shapes())
        x = x.to(self.dtype).permute(0, 3, 1, 2)
        x = self.ConvBN_0(p["ConvBN_0"], x)
        x = self.ConvBN_1(p["ConvBN_1"], x)
        x = self.Residual_0(p["Residual_0"], x)
        x = self.ConvBN_2(p["ConvBN_2"], x)
        x = self.ConvBN_3(p["ConvBN_3"], x)
        x = self.Residual_1(p["Residual_1"], x)
        x = F.max_pool2d(x, 2)
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        x = x @ p["Dense_0"]["kernel"].to(x.dtype)
        return (x * self.weight).to(torch.float32)
