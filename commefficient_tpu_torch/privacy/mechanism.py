"""In-round DP primitives: per-client clip, aggregated-table noise, and
the seeded noise streams.

Port of ``commefficient_tpu/privacy/mechanism.py`` (``gaussian_noise``
:80, ``dp_clip`` :86, ``table_sensitivity`` :96, ``table_noise_std``
:106, ``add_table_noise`` :113). The ``--dp sketch`` mechanism:

1. each participating client's gradient (the microbatch-summed total,
   never divided by the batch size, core/grad.py) is L2-clipped to
   ``--dp_clip`` (``dp_clip``, the clip algebra of core/robust.py);
2. the round's aggregated sketch table, after the fold and its
   division by the static W·B capacity and before any wire
   quantization, takes one Gaussian draw of std ``table_noise_std``.
   The released value is what the accountant charges for; the int8/fp8
   qdq after it is post-processing.

One client's table has L2 norm at most sqrt(r)·dp_clip·n_i with
n_i <= B, so its share of the aggregate is at most sqrt(r)·C/W on
every round; the noise std is ``dp_noise_mult`` times that bound.

The draws come from ``torch.Generator`` streams on the round's device,
each seeded from (seed, index, tag) by ``stream_seed``: the table noise
of round i from (--seed, i, ``NOISE_TAG``), the legacy ``--do_dp``
worker noise of round i from (--seed, i, ``WORKER_NOISE_TAG``), its
server noise of step s from (--seed + 1, s, ``SERVER_NOISE_TAG``), as
the reference takes its server noise from a seed + 1 root. The tags
lie past every client id, so no stream is a per-client one. The same
(seed, index, tag) gives the same bits. JAX's threefry and torch's
Philox never agree, so the noise is held to the reference by its
distribution, never bit for bit.
"""

from __future__ import annotations

import math

import torch

from commefficient_tpu_torch.core.robust import clip_factors

# out of range for any client id (int32 client indices)
NOISE_TAG = 0x7FFFFFFF
WORKER_NOISE_TAG = 0x7FFFFFFE
SERVER_NOISE_TAG = 0x7FFFFFFD

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def stream_seed(seed: int, index: int, tag: int) -> int:
    """A 63-bit generator seed from (seed, index, tag), host integers
    only: distinct triples give unrelated seeds."""
    h = _splitmix64(int(seed) & _MASK64)
    h = _splitmix64(h ^ (int(index) & _MASK64))
    h = _splitmix64(h ^ (int(tag) & _MASK64))
    return h & ((1 << 63) - 1)


def noise_generator(seed: int, index: int, tag: int,
                    device) -> torch.Generator:
    """The noise stream (seed, index, tag) on ``device``."""
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(stream_seed(seed, index, tag))
    return gen


def gaussian_noise(gen: torch.Generator, shape, dtype=torch.float32,
                   std: float = 1.0) -> torch.Tensor:
    """std · N(0, 1) of ``shape`` from ``gen``, on its device."""
    return std * torch.randn(tuple(shape), generator=gen, dtype=dtype,
                             device=gen.device)


def dp_clip(g: torch.Tensor, cap: float) -> torch.Tensor:
    """L2-clip one client's gradient to ``cap`` with the factor
    min(1, cap / max(norm, tiny)) of ``clip_factors``: the identity
    inside the cap. Composes with ``torch.func.vmap``."""
    norm = torch.sqrt(torch.sum(g * g))
    return g * clip_factors(norm, cap)


def table_sensitivity(num_rows: int, clip: float, num_workers: int) -> float:
    """One client's largest L2 contribution to the aggregated table:
    sqrt(r)·C/W."""
    return math.sqrt(num_rows) * float(clip) / float(num_workers)


def table_noise_std(cfg) -> float:
    """The mechanism's noise std: dp_noise_mult × the sensitivity."""
    return float(cfg.dp_noise_mult) * table_sensitivity(
        cfg.num_rows, cfg.dp_clip, cfg.num_workers)


def add_table_noise(table: torch.Tensor, gen: torch.Generator,
                    std: float) -> torch.Tensor:
    """The release: the aggregated table + N(0, std²), drawn before any
    wire quantization."""
    return table + gaussian_noise(gen, table.shape, table.dtype, std=std)
