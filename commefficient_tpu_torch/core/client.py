"""One client's momentum, error feedback and compression.

Port of ``commefficient_tpu/core/client.py`` (``ClientUpdate``,
``accumulate_and_compress`` :41, ``stale_weight_download`` :93), the
reference worker's ``local_step``:
- the transmitted quantity is the sum of gradients over the client's
  batch, ``g = g_unit * batch_size``;
- local momentum ``velocity = g + m * velocity``;
- local error ``error += velocity`` (or ``g``), and the error is sent;
- local_topk sends the top-k of that, then zeroes the error (error
  feedback) and the velocity (momentum factor masking) where it sent.

Every tensor here carries a leading client axis: the C clients of a
chunk of the round (core/rounds.py), where the reference maps one
client's step with ``jax.vmap``. local_topk selects row by row.
State a mode does not use is ``None``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.topk import topk


class ClientUpdate(NamedTuple):
    transmit: torch.Tensor               # what this client uploads
    velocity: Optional[torch.Tensor]     # new local momentum, or None
    error: Optional[torch.Tensor]        # new local error, or None


def topk_rows(x: torch.Tensor, k: int, live: Optional[int] = None
              ) -> torch.Tensor:
    """Row-wise top-k of the (C, d) stack ``x``, in its first ``live``
    rows only: the rows after them are a chunk's padding, dead slots
    whose results the round drops, so they pass unselected and launch
    no selection."""
    if live is None or live >= x.shape[0]:
        return topk(x, k=k)
    return torch.cat([topk(x[:live], k=k), x[live:]])


def accumulate_and_compress(cfg: Config, g_unit: torch.Tensor,
                            velocity: Optional[torch.Tensor],
                            error: Optional[torch.Tensor],
                            batch_size: torch.Tensor,
                            live: Optional[int] = None) -> ClientUpdate:
    """``g_unit`` is the (C, ...) stack of the clients' per-sample-mean
    gradients (the output of ``core/grad.py`` ``forward_grad``:
    weight-decayed, clipped and in sketch mode sketched);
    ``batch_size`` their (C,) real sample counts; rows from ``live`` on
    are padding (``topk_rows``)."""
    has_velocity = cfg.local_momentum > 0
    has_error = cfg.error_type == "local"
    assert (velocity is not None) == has_velocity
    assert (error is not None) == has_error

    g = g_unit * batch_size.reshape((-1,) + (1,) * (g_unit.ndim - 1))
    if has_velocity:
        velocity = g + cfg.local_momentum * velocity
    if has_error:
        error = error + (velocity if has_velocity else g)
        to_transmit = error
    else:
        to_transmit = velocity if has_velocity else g

    if cfg.mode == "local_topk":
        assert cfg.error_type in ("local", "none")
        to_transmit = topk_rows(to_transmit, cfg.k, live)
        kept = to_transmit != 0
        zero = torch.zeros((), dtype=to_transmit.dtype,
                           device=to_transmit.device)
        if has_error:
            error = torch.where(kept, zero, error)
        if has_velocity:
            velocity = torch.where(kept, zero, velocity)

    if has_error:
        assert cfg.mode not in ("sketch", "uncompressed")
    if has_velocity:
        assert cfg.mode != "sketch"
    return ClientUpdate(to_transmit, velocity, error)


def stale_weight_download(cfg: Config, ps_weights: torch.Tensor,
                          client_weights: torch.Tensor,
                          live: Optional[int] = None) -> torch.Tensor:
    """``--topk_down``: each client catches up to the server by
    applying only the top-k of the weight difference to its stale
    weights, (C, d) rows (reference ``get_new_worker_weights``); rows
    from ``live`` on are padding (``topk_rows``)."""
    diff = ps_weights - client_weights
    if cfg.do_topk_down:
        diff = topk_rows(diff, cfg.k, live)
    return client_weights + diff
