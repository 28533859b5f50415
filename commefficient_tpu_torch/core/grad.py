"""One client's gradient: microbatching, clipping, weight decay,
sketching.

Port of ``commefficient_tpu/core/grad.py`` (``make_forward_grad`` :49),
without DP (its flags raise at parse time). A loss function here is

    loss_fn(params_flat, batch) -> (loss, metrics_tuple)

over one client's batch, a dict of tensors whose leading axis is the
sample axis with a float ``"mask"`` marking real samples; ``loss`` and
the metrics are masked means over the real samples.

The reference's semantics:
- with microbatching, the gradient is the sum over microbatches of
  each microbatch's mean gradient (the reference worker's
  ``loss.backward()`` accumulation), which is why the clip threshold
  scales with the number of microbatches;
- the non-sketch clip at ``max_grad_norm * ceil(n / mb)``, n taken
  from the mask;
- weight decay ``g += (wd / num_workers) * weights``;
- sketch mode: sketch the gradient, then clip the table by its
  l2estimate when ``max_grad_norm`` is set.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.sketch import CountSketch, clip_record
from commefficient_tpu_torch.ops.vec import clip_by_l2


def _masked_count(batch) -> torch.Tensor:
    return torch.clamp(torch.sum(batch["mask"]), min=1.0)


def make_forward_grad(cfg: Config, loss_fn: Callable,
                      sketch: Optional[CountSketch],
                      padded_batch_size: int) -> Callable:
    """Returns ``forward_grad(params_flat, batch) -> (transmit_unit,
    metrics)``: the per-sample-mean gradient (the (r, c) table of it in
    sketch mode) and the batch-mean metrics, loss first. Nothing in it
    reads a device value on the host."""
    if cfg.microbatch_size > 0:
        mb = min(cfg.microbatch_size, padded_batch_size)
        num_iters = math.ceil(padded_batch_size / mb)
    else:
        mb, num_iters = padded_batch_size, 1
    pad_to = num_iters * mb

    def one_microbatch(params_flat, microbatch):
        p = params_flat.detach().requires_grad_(True)
        loss, metrics = loss_fn(p, microbatch)
        (g,) = torch.autograd.grad(loss, p)
        n = torch.sum(microbatch["mask"])
        # an all-padding microbatch contributes nothing
        valid = n > 0
        g = torch.where(valid, g, torch.zeros_like(g))
        weighted = tuple(torch.where(valid, m.detach(),
                                     torch.zeros_like(m)) * n
                         for m in (loss,) + tuple(metrics))
        return g, weighted

    def forward_grad(params_flat, batch):
        if num_iters == 1:
            g, weighted = one_microbatch(params_flat, batch)
        else:
            def pad(x):
                extra = x.new_zeros((pad_to - x.shape[0],) + x.shape[1:])
                return torch.cat([x, extra])

            padded = {k: pad(v) for k, v in batch.items()}
            g, weighted = None, None
            for i in range(num_iters):
                g_i, w_i = one_microbatch(
                    params_flat,
                    {k: v[i * mb:(i + 1) * mb] for k, v in padded.items()})
                if g is None:
                    g, weighted = g_i, w_i
                else:
                    g = g + g_i
                    weighted = tuple(a + w for a, w in zip(weighted, w_i))

        batch_size = _masked_count(batch)
        metrics = tuple(w / batch_size for w in weighted)

        if cfg.max_grad_norm is not None and cfg.mode != "sketch":
            real_iters = torch.ceil(batch_size / mb)
            g = clip_by_l2(g, cfg.max_grad_norm * real_iters)

        if cfg.weight_decay != 0:
            g = g + (cfg.weight_decay / cfg.num_workers) * params_flat

        if cfg.mode == "sketch":
            assert sketch is not None
            table = sketch.sketch(g)
            if cfg.max_grad_norm is not None:
                table = clip_record(table, cfg.max_grad_norm,
                                    is_sketch=True)
            return table, metrics
        return g, metrics

    return forward_grad
