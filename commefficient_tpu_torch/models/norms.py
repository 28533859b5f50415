"""Batch-statistics normalization and the ResNet family's LayerNorm
(port of ``commefficient_tpu/models/norms.py`` and the ``norm="layer"``
of ``models/resnets.py``), on NCHW activations.

``BatchStatNorm`` normalizes each channel by the statistics of ONE
client's batch, as the JAX package's clients do under ``jax.vmap``.
The port runs all W clients of a round (or all S shards of a
validation step) in one forward, so the batch axis holds ``ctx.groups``
groups of B samples, and the statistics reduce over (B, H, W) for each
group: one launch, and no sample ever normalized by another client's
data. With a mask (``--batchnorm``'s tracked norms) padded rows stay
out of the statistics; without one (the ResNet family, ResNet18) they
run over all B rows of the group, as in the JAX package.
``track_stats`` records the raw mean and the Bessel-corrected variance
into ``ctx.record``; the server blends them into its running
statistics (runtime/fed_model.py), which eval normalizes by
(``ctx.running``).
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.models.layers import Ctx, Leaf, ones, zeros


class BatchStatNorm:
    """(JAX norms.py:30-94). ``path`` is the site's place in the
    parameter tree, the key of its running statistics."""
    epsilon = 1e-5

    def __init__(self, c: int, path: tuple, track_stats: bool = False):
        self.c, self.path = c, tuple(path)
        self.track_stats = track_stats

    def spec(self):
        return {"scale": Leaf((self.c,), ones),
                "bias": Leaf((self.c,), zeros)}

    def state_spec(self):
        if not self.track_stats:
            return {}
        return {"mean": Leaf((self.c,), zeros), "var": Leaf((self.c,), ones)}

    def __call__(self, p, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        g = ctx.groups
        if ctx.running is not None:
            assert self.track_stats, "use_running_average needs track_stats"
            mean = ctx.running[self.path + ("mean",)][None]
            var = ctx.running[self.path + ("var",)][None]
        else:
            # statistics reduce in f32 whatever the compute dtype
            xf = x.to(torch.float32).reshape((g, -1) + x.shape[1:])
            hw = x.shape[2] * x.shape[3]
            if ctx.mask is not None:
                w = ctx.mask.to(torch.float32).reshape(g, -1, 1, 1, 1)
                n = torch.clamp(torch.sum(w, dim=(1, 2, 3, 4)) * float(hw),
                                min=1.0)[:, None]
                mean = torch.sum(xf * w, dim=(1, 3, 4)) / n
                var = torch.sum(torch.square(xf - mean[:, None, :, None,
                                                       None]) * w,
                                dim=(1, 3, 4)) / n
                bessel = n / torch.clamp(n - 1.0, min=1.0)
            else:
                mean = torch.mean(xf, dim=(1, 3, 4))
                var = torch.mean(torch.square(
                    xf - mean[:, None, :, None, None]), dim=(1, 3, 4))
                n = float(xf.shape[1] * hw)
                bessel = n / max(n - 1.0, 1.0)
            if self.track_stats and ctx.record is not None:
                ctx.record[self.path + ("mean",)] = mean
                ctx.record[self.path + ("var",)] = var * bessel
        inv = (p["scale"] * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        shift = (p["bias"] - mean * inv).to(x.dtype)
        xg = x.reshape((mean.shape[0], -1) + x.shape[1:])
        out = (xg * inv[:, None, :, None, None]
               + shift[:, None, :, None, None])
        return out.reshape(x.shape)


class LayerNorm:
    """flax ``LayerNorm`` over (H, W, C) with affine over the same axes
    (JAX resnets.py:31-38): per-sample mean and the fast variance
    E[x^2] - E[x]^2 clipped at 0, epsilon 1e-6. ``hwc`` is the
    activation's (H, W, C) at this site."""
    epsilon = 1e-6

    def __init__(self, hwc: tuple):
        self.hwc = tuple(hwc)

    def spec(self):
        return {"scale": Leaf(self.hwc, ones), "bias": Leaf(self.hwc, zeros)}

    def __call__(self, p, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        xf = x.to(torch.float32)
        mean = torch.mean(xf, dim=(1, 2, 3), keepdim=True)
        mean2 = torch.mean(xf * xf, dim=(1, 2, 3), keepdim=True)
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        scale = p["scale"].permute(2, 0, 1)[None]
        bias = p["bias"].permute(2, 0, 1)[None]
        y = (xf - mean) * (torch.rsqrt(var + self.epsilon) * scale) + bias
        return y.to(x.dtype)
