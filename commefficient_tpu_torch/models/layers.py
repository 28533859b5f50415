"""Building blocks of the flat-vector CV models (ResNet family, Fixup,
ResNet18).

A model here declares its parameters as a nested dict of ``Leaf``
(shape and initializer) under the flax module's own names, so the
dict's ``ravel_order`` is the JAX package's ``ravel_pytree`` order and
``from_jax_params`` carries a flax tree over leaf for leaf. ``Names``
hands out flax's automatic submodule names (``Conv_0``, ``Conv_1``,
``LayerNorm_0``, ...) in the order the flax module creates them.
Convolutions take flax's HWIO kernels and run NCHW.

``Ctx`` carries what the batch-statistics norms need through a
forward: how many independent groups of samples the batch holds (the
clients of a round, or the shards of a validation step, each
normalized by its own statistics), their (groups, B) mask, the running
statistics to normalize by in eval, and a dict to record each site's
batch statistics into.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from commefficient_tpu_torch.ops.vec import (flat_size, flatten_params,
                                             params_tree, ravel_order)

# flax layout -> torch layout: (kh, kw, cin, cout) -> (cout, cin, kh, kw)
CONV_TO_TORCH = (3, 2, 0, 1)


class Leaf(NamedTuple):
    shape: tuple
    init: Callable  # (shape, torch.Generator) -> f32 tensor


def he_normal(shape, gen):
    """flax's he_normal: variance 2/fan_in, normal truncated at two
    standard deviations (fan_in: every axis but the last)."""
    fan_in = int(np.prod(shape[:-1]))
    std = math.sqrt(2.0 / fan_in) / .87962566103423978
    w = torch.empty(shape, dtype=torch.float32)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=gen)
    return w


def fixup_normal(scale: float) -> Callable:
    """The Fixup conv init (JAX ``_fixup_conv_init``): normal with std
    ``scale * sqrt(2 / (c_out * kh * kw))``; zeros at scale 0."""
    def init(shape, gen):
        fan = shape[-1] * int(np.prod(shape[:-2]))
        std = scale * math.sqrt(2.0 / fan)
        return torch.randn(shape, generator=gen) * std
    return init


def zeros(shape, gen):
    return torch.zeros(shape, dtype=torch.float32)


def ones(shape, gen):
    return torch.ones(shape, dtype=torch.float32)


class Names:
    """flax's automatic names: ``Names()("Conv")`` gives ``Conv_0``,
    then ``Conv_1``; each module class counts on its own."""

    def __init__(self):
        self._counts: Dict[str, int] = {}

    def __call__(self, kind: str) -> str:
        n = self._counts.get(kind, 0)
        self._counts[kind] = n + 1
        return f"{kind}_{n}"


class Ctx:
    """Per-forward context of the batch-statistics norms: ``groups``
    independent sample groups along the batch axis, their (groups, B)
    ``mask`` (or None: statistics over every row), ``running`` (the
    server's running statistics tree, to normalize by in eval) and
    ``record`` (a dict that collects each tracking site's (groups, C)
    batch mean and Bessel-corrected variance, keyed by its path)."""

    def __init__(self, groups: int = 1, mask=None, running=None,
                 record: Optional[dict] = None):
        self.groups, self.mask = groups, mask
        self.running, self.record = running, record


def out_size(n: int, k: int, stride: int, pad: int) -> int:
    return (n + 2 * pad - k) // stride + 1


def conv(x, kernel, stride=1, padding=0, groups=1):
    """NCHW convolution with a flax HWIO kernel, in ``x``'s dtype."""
    weight = kernel.to(x.dtype).permute(*CONV_TO_TORCH).contiguous()
    return F.conv2d(x, weight, stride=stride, padding=padding, groups=groups)


def dense(x, p):
    """flax ``Dense``: x @ kernel (+ bias), in ``x``'s dtype."""
    y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(x.dtype)
    return y


def to_nhwc_flat(x):
    """(N, C, H, W) -> (N, H*W*C), flattened as flax flattens NHWC."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def spec_shapes(spec: dict) -> dict:
    return {k: spec_shapes(v) if isinstance(v, dict) else tuple(v.shape)
            for k, v in spec.items()}


class FlatModel(nn.Module):
    """A CV model over the flat f32 parameter vector. Subclasses give
    ``spec()`` (the nested ``Leaf`` dict of the parameters) and, where
    norms track batch statistics, ``state_spec()``; ``forward(flat, x,
    groups=1, mask=None, running=None, record=None)`` takes (N, H, W,
    C) images and returns (N, num_classes) f32 logits."""

    def spec(self) -> dict:
        raise NotImplementedError

    def state_spec(self) -> dict:
        return {}

    def leaf_shapes(self) -> dict:
        shapes = self.__dict__.get("_leaf_shapes")
        if shapes is None:
            shapes = self.__dict__["_leaf_shapes"] = spec_shapes(self.spec())
        return shapes

    @property
    def tracks_stats(self) -> bool:
        return bool(self.state_spec())

    @property
    def num_params(self) -> int:
        return flat_size(self.leaf_shapes())

    def init_flat(self, seed: int, device="cpu") -> torch.Tensor:
        """Random flat parameters from ``seed``, each leaf drawn by its
        initializer on the CPU from one seeded generator in ravel
        order. The draws differ from jax.random's; tests carry JAX
        weights over with ``from_jax_params`` instead."""
        gen = torch.Generator().manual_seed(int(seed))
        parts = [leaf.init(leaf.shape, gen).reshape(-1)
                 for _, leaf in ravel_order(self.spec())]
        return torch.cat(parts).to(device)

    def init_state(self, device="cpu") -> dict:
        """The running statistics at flax's init (mean 0, var 1), as
        {leaf path: tensor}."""
        return {path: leaf.init(leaf.shape, None).to(device)
                for path, leaf in ravel_order(self.state_spec())}

    def to_params_tree(self, flat: torch.Tensor) -> dict:
        """The flat vector -> the flax parameter tree as numpy f32
        arrays, keys sorted at every level as the JAX package's
        ``unravel`` of its flat vector gives them (the inverse of
        ``from_jax_params``)."""
        return params_tree(flat, self.leaf_shapes())

    def from_jax_params(self, params_np: dict, device="cpu") -> torch.Tensor:
        """The JAX package's flax parameter tree, as numpy arrays ->
        the port's flat vector (bit-identical to ravel_pytree)."""
        want = [(p, tuple(s)) for p, s in ravel_order(self.leaf_shapes())]
        got = [(p, tuple(np.shape(a))) for p, a in ravel_order(params_np)]
        if want != got:
            raise ValueError(f"parameter tree mismatch: {got} != {want}")
        return flatten_params(params_np, device)

