"""Clients' gradients: microbatching, clipping, weight decay,
sketching, for a chunk of clients in one batched pass.

Port of ``commefficient_tpu/core/grad.py`` (``make_forward_grad`` :49).
A loss function here is

    loss_fn(params_flat, batch) -> (loss, metrics_tuple)

over one client's batch, a dict of tensors whose leading axis is the
sample axis with a float ``"mask"`` marking real samples; ``loss`` and
the metrics are masked means over the real samples. It must compose
with ``torch.func`` (plain PyTorch operations: no kernel launch, no
in-place write to its inputs), because the clients of a chunk run it
under ``torch.func.vmap`` (the reference's ``jax.vmap`` of
``per_client``, core/rounds.py:799-808).

The reference's semantics:
- with microbatching, the gradient is the sum over microbatches of
  each microbatch's mean gradient (the reference worker's
  ``loss.backward()`` accumulation), which is why the clip threshold
  scales with the number of microbatches;
- the non-sketch clip at ``max_grad_norm * ceil(n / mb)``, n taken
  from the mask;
- weight decay ``g += (wd / num_workers) * weights``;
- the legacy ``--do_dp``: L2-clip to ``--l2_norm_clip``; under
  ``--dp_mode worker`` add ``noise_multiplier`` · N(0, 1) ·
  sqrt(num_workers), drawn outside ``vmap`` from the round's worker
  noise stream (privacy/mechanism.py), a (C, d) block a chunk;
- ``--dp sketch``: L2-clip the gradient to ``--dp_clip`` before it is
  sketched (``dp_clip``);
- sketch mode: sketch the gradient, then clip the table by its
  l2estimate when ``max_grad_norm`` is set. The sketch is a kernel
  launch, so it runs after the batched pass, once a client, on the
  (C, d) gradient stack.

Under ``--remat`` (GPT-2's blocks recomputed in the backward by
``torch.utils.checkpoint``, which does not compose with ``torch.func``
transforms) the clients of a chunk run one after another in plain
autograd (``map_clients``), each gradient by ``torch.autograd.grad``:
the same function of each client's batch, the same (C, ...) stacks
after. Peak memory is then one client's checkpointed activations
where the batched pass holds every client's.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.sketch import CountSketch, clip_record
from commefficient_tpu_torch.ops.vec import clip_by_l2
from commefficient_tpu_torch.privacy.mechanism import dp_clip, gaussian_noise


def pad_samples(batch: dict, n: int) -> dict:
    """Zero-pad the sample axis (axis 1 of a (C, B, ...) chunk) to
    ``n``: the padding's mask is 0."""
    def pad(x):
        extra = n - x.shape[1]
        if extra <= 0:
            return x
        return torch.cat([x, x.new_zeros((x.shape[0], extra)
                                         + x.shape[2:])], dim=1)

    return {k: pad(v) for k, v in batch.items()}


def make_client_grad(cfg: Config, loss_fn: Callable,
                     padded_batch_size: int) -> Callable:
    """Returns ``client_grad(params_flat, batch) -> (g, metrics)`` for
    ONE client, a function to run under ``torch.func.vmap``: the
    per-sample-mean dense gradient (clipped outside sketch mode,
    weight-decayed, DP-clipped) and the batch-mean metrics, loss first.
    The worker DP noise is not in it (``worker_noise``). ``batch``
    holds ``num_iters * mb`` samples (``pad_samples`` to
    ``padded_to(cfg, padded_batch_size)``)."""
    mb, num_iters = _microbatching(cfg, padded_batch_size)

    def loss_and_aux(p, microbatch):
        loss, metrics = loss_fn(p, microbatch)
        return loss, (loss,) + tuple(metrics)

    grad_fn = (_autograd_grad(loss_and_aux) if cfg.do_remat
               else torch.func.grad(loss_and_aux, has_aux=True))

    def one_microbatch(params_flat, microbatch):
        g, mets = grad_fn(params_flat, microbatch)
        n = torch.sum(microbatch["mask"])
        # an all-padding microbatch contributes nothing
        valid = n > 0
        g = torch.where(valid, g, torch.zeros_like(g))
        weighted = tuple(torch.where(valid, m, torch.zeros_like(m)) * n
                         for m in mets)
        return g, weighted

    def client_grad(params_flat, batch):
        g, weighted = None, None
        for i in range(num_iters):
            g_i, w_i = one_microbatch(
                params_flat,
                {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()})
            if g is None:
                g, weighted = g_i, w_i
            else:
                g = g + g_i
                weighted = tuple(a + w for a, w in zip(weighted, w_i))

        batch_size = torch.clamp(torch.sum(batch["mask"]), min=1.0)
        metrics = tuple(w / batch_size for w in weighted)

        if cfg.max_grad_norm is not None and cfg.mode != "sketch":
            real_iters = torch.ceil(batch_size / mb)
            g = clip_by_l2(g, cfg.max_grad_norm * real_iters)

        if cfg.weight_decay != 0:
            g = g + (cfg.weight_decay / cfg.num_workers) * params_flat

        if cfg.do_dp:
            g = clip_by_l2(g, cfg.l2_norm_clip)
        if cfg.dp == "sketch":
            g = dp_clip(g, cfg.dp_clip)
        return g, metrics

    return client_grad


def _autograd_grad(f: Callable) -> Callable:
    """``torch.func.grad(f, has_aux=True)`` in plain autograd, for one
    client outside any ``torch.func`` transform (``--remat``)."""

    def grad_fn(p, *args):
        p = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss, aux = f(p, *args)
            (g,) = torch.autograd.grad(loss, p)
        return g, tuple(a.detach() for a in aux)

    return grad_fn


def map_clients(fn: Callable, in_dims, serial: bool) -> Callable:
    """``torch.func.vmap(fn, in_dims)`` over a chunk's client axis, or
    with ``serial`` the same map as a loop over the clients whose
    outputs are stacked (``--remat``). ``in_dims`` holds 0 (the client
    axis leads; a dict's tensors each) or None (shared) per
    argument."""
    if not serial:
        return torch.func.vmap(fn, in_dims=in_dims)

    def pick(arg, dim, i):
        if dim is None:
            return arg
        if isinstance(arg, dict):
            return {k: v[i] for k, v in arg.items()}
        return arg[i]

    def stack(outs):
        if isinstance(outs[0], torch.Tensor):
            return torch.stack(outs)
        return tuple(stack(col) for col in zip(*outs))

    def looped(*args):
        lead = next(a for a, d in zip(args, in_dims) if d is not None)
        n = (next(iter(lead.values())) if isinstance(lead, dict)
             else lead).shape[0]
        return stack([fn(*(pick(a, d, i) for a, d in zip(args, in_dims)))
                      for i in range(n)])

    return looped


class NoiseSlice(NamedTuple):
    """A mesh rank's share of the round's worker noise stream: the
    stream is drawn for the round's ``total`` clients in slot order and
    the rank's ``[lo, lo + n)`` kept, so its clients take the numbers
    the one-card round gives them, not the stream's head."""
    gen: torch.Generator
    lo: int
    total: int


def worker_noise(cfg: Config, gen, shape):
    """The legacy ``--do_dp --dp_mode worker`` noise of ``shape`` (the
    client axis leading), noise_multiplier · N(0, 1) · sqrt(num_workers)
    from ``gen`` (a generator, or a mesh rank's ``NoiseSlice``); None
    where the round adds none (no generator: DP off, server mode, or a
    zero multiplier, whose draw would add exact zeros)."""
    if gen is None:
        return None
    if isinstance(gen, NoiseSlice):
        full = gaussian_noise(gen.gen, (gen.total,) + tuple(shape[1:]),
                              std=cfg.noise_multiplier)
        noise = full[gen.lo:gen.lo + shape[0]]
    else:
        noise = gaussian_noise(gen, shape, std=cfg.noise_multiplier)
    return noise * math.sqrt(float(cfg.num_workers))


def _microbatching(cfg: Config, padded_batch_size: int):
    """(microbatch size, microbatches a client)."""
    if cfg.microbatch_size > 0:
        mb = min(cfg.microbatch_size, padded_batch_size)
        return mb, math.ceil(padded_batch_size / mb)
    return padded_batch_size, 1


def padded_to(cfg: Config, padded_batch_size: int) -> int:
    """Samples a client's batch is padded to for its microbatches."""
    mb, num_iters = _microbatching(cfg, padded_batch_size)
    return mb * num_iters


def make_forward_grad(cfg: Config, loss_fn: Callable,
                      sketch: Optional[CountSketch],
                      padded_batch_size: int) -> Callable:
    """Returns ``forward_grad(params_flat, batch, noise_gen=None) ->
    (transmit_unit, metrics)`` over a chunk of C clients, ``noise_gen``
    the round's worker noise stream: ``batch`` holds (C, B, ...)
    tensors, ``params_flat`` is the shared (d,) vector or a (C, d) stack
    (``--topk_down``'s stale weights). It gives the (C, d) per-sample-
    mean gradients (in sketch mode the (C, r, c) tables of them, each
    clipped by its own l2estimate under ``max_grad_norm``) and (C,)
    metrics, loss first. Nothing in it reads a device value on the
    host."""
    client_grad = make_client_grad(cfg, loss_fn, padded_batch_size)
    n = padded_to(cfg, padded_batch_size)

    def forward_grad(params_flat, batch, noise_gen=None):
        in_p = 0 if params_flat.ndim == 2 else None
        g, metrics = map_clients(client_grad, (in_p, 0), cfg.do_remat)(
            params_flat, pad_samples(batch, n))
        noise = worker_noise(cfg, noise_gen, g.shape)
        if noise is not None:
            g = g + noise
        if cfg.mode != "sketch":
            return g, metrics
        assert sketch is not None
        table = torch.stack([sketch.sketch(row) for row in g])
        if cfg.max_grad_norm is not None:
            table = clip_record(table, cfg.max_grad_norm, is_sketch=True)
        return table, metrics

    return forward_grad
