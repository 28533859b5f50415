"""Server-side update: virtual momentum, virtual error feedback,
unsketching.

Port of the sketch-mode parts of ``commefficient_tpu/core/server.py``
(``ServerState`` :28, ``fold_row_chunks`` :66, ``_lr_scaled_support``
:124, ``server_update`` :146, ``_sketched`` :279, with its dense and
its sparse re-sketch branches).
``gradient`` is the round's aggregated quantity: the (r, c) sketch
table of the client-transmit sum divided by the round's total
datapoint count. Functions return new tensors; nothing is updated in
place, so a caller may keep the previous state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.sketch import CountSketch


class ServerState(NamedTuple):
    """Virtual momentum and error buffers, sketch-table shaped."""
    Vvelocity: torch.Tensor
    Verror: torch.Tensor

    @staticmethod
    def init(cfg: Config, device="cuda") -> "ServerState":
        def z():
            return torch.zeros(cfg.transmit_shape, dtype=torch.float32,
                               device=device)
        return ServerState(z(), z())


def fold_row_chunks(chunks) -> torch.Tensor:
    """Reassemble the (r, c) table from its dequantized row chunks
    (``--overlap_depth``) in emission order. The chunks cover disjoint
    row ranges, so the fold is concatenation, with no summation."""
    return torch.cat(list(chunks), dim=0)


class ServerUpdate(NamedTuple):
    # subtract from ps_weights (already lr-scaled); None on the sparse
    # re-sketch branch, where ``support`` carries the update
    weight_update: Optional[torch.Tensor]
    state: ServerState
    # dense branch: (n,) int64 indices of the coordinates the lr-scaled
    # update changes (nonzero); sparse branch: ((k,) ascending indices,
    # (k,) lr-scaled values). On the device; download accounting reads
    # only these
    support: object


def _lr_scaled_support(idx, vals, lr):
    """Support of the weight update: its values scaled by the LR."""
    return idx, vals * lr


def server_update(cfg: Config, gradient: torch.Tensor, state: ServerState,
                  lr: torch.Tensor, sketch: Optional[CountSketch] = None
                  ) -> ServerUpdate:
    """Dispatch on mode (reference ``server_update``); only sketch
    mode is ported."""
    if cfg.mode != "sketch":
        raise NotImplementedError(f"--mode {cfg.mode} is not ported")
    return _sketched(cfg, gradient, state, lr, sketch)


def _sketched(cfg: Config, sketched_grad: torch.Tensor,
              state: ServerState, lr: torch.Tensor,
              sketch: CountSketch) -> ServerUpdate:
    """FetchSGD server step: momentum and error accumulate in (r, c)
    table space; exact top-k recovery; error feedback and momentum
    factor masking at the nonzero buckets of the recovered update's
    re-sketch."""
    assert sketch is not None
    if cfg.error_type == "local":
        assert cfg.virtual_momentum == 0
    elif cfg.error_type == "virtual":
        assert cfg.local_momentum == 0

    Vvel = sketched_grad + cfg.virtual_momentum * state.Vvelocity
    if cfg.error_type == "local":
        Verr = Vvel
    elif cfg.error_type == "virtual":
        Verr = state.Verror + Vvel
    else:  # "none": Verror stays zero forever -> zero updates
        Verr = state.Verror

    # At large d (d > 90*r*k) the k-sparse form wins: the recovered
    # update is re-sketched by O(r*k) scatter-adds and never exists as
    # a dense (d,) vector. Otherwise exact recovery goes through the
    # threshold mask (dense regime) or the index path.
    sparse = sketch.prefer_sparse_resketch(cfg.k)
    if sketch.prefer_threshold_unsketch(cfg.k):  # implies not sparse
        update, _ = sketch.unsketch_dense_mask(Verr, k=cfg.k)
    elif sparse:
        _, idx, vals = sketch.unsketch(Verr, k=cfg.k, with_support=True,
                                       with_dense=False)
    else:
        update = sketch.unsketch(Verr, k=cfg.k)

    # re-sketch the recovered update to find which table buckets it
    # occupies; a bucket is kept only where no selected coordinate
    # landed (exact zero: contributions of real values cancel only by
    # exact cancellation, whatever the order of the scatter's sums)
    sketched_update = (sketch.sketch_sparse(idx, vals) if sparse
                       else sketch.sketch(update))
    keep = sketched_update == 0
    zero = torch.zeros((), dtype=torch.float32, device=Verr.device)
    if cfg.error_type == "virtual":
        Verr = torch.where(keep, Verr, zero)
    Vvel = torch.where(keep, Vvel, zero)
    if cfg.error_type == "local":
        Verr = Vvel
    state = ServerState(Vvel, Verr)

    if sparse:
        return ServerUpdate(None, state, _lr_scaled_support(idx, vals, lr))
    weight_update = update * lr
    support = torch.nonzero(weight_update).flatten()
    return ServerUpdate(weight_update, state, support)
