"""Server-side update: virtual momentum, virtual error feedback,
unsketching and top-k recovery.

Port of ``commefficient_tpu/core/server.py`` (``ServerState`` :28,
``fold_row_chunks`` :66, ``_lr_scaled_support`` :124,
``server_update`` :146, with a 0-dim or a per-coordinate (d,) LR,
``staleness_weights`` :102 for the asynchronous rounds' fold,
``_fedavg`` :194, ``_uncompressed`` :205 with the legacy ``--do_dp
--dp_mode server`` noise, ``_true_topk`` :225, ``_local_topk`` :267 and
``_sketched`` :279 with its dense and its sparse re-sketch branches),
and their schema-v2 probes (``probes=True``: ``_state_probes`` :185,
``_coverage`` :137), the 2-D mesh's model-sharded sketch server
(``sketched_update_2d`` and ``_psum_l2``, :364-470), and its dense
server (``uncompressed_update_2d``: ``_uncompressed`` on a window of
the coordinates, the reference's ``_build_server_round_2d_dense``,
core/rounds.py:1477-1505).
``gradient`` is the round's aggregated quantity: the client-transmit
sum divided by the round's total datapoint count, a flat (d,) vector
or, in sketch mode, an (r, c) table. Functions return new tensors;
nothing is updated in place, so a caller may keep the previous state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.ops.vec import packbits
from commefficient_tpu_torch.privacy.mechanism import gaussian_noise


class ServerState(NamedTuple):
    """Virtual momentum and error buffers, transmit shaped."""
    Vvelocity: torch.Tensor
    Verror: torch.Tensor

    @staticmethod
    def init(cfg: Config, device="cuda", model_axis: int = 1,
             model_index: int = 0) -> "ServerState":
        """Zeros of the transmit shape; on a model axis of M ranks, rank
        ``model_index``'s shard (reference runtime/fed_model.py:1241-1265
        and parallel/mesh.py ``server_state_spec``: 1/M of the state a
        rank): a sketch table's (r, c/M) column shard, a dense (d,)
        vector's window of ceil(d/M) coordinates (``dense_window``; the
        last one short)."""
        shape = tuple(cfg.transmit_shape)
        if model_axis > 1 and len(shape) == 2:
            assert shape[1] % model_axis == 0, shape
            shape = (shape[0], shape[1] // model_axis)
        elif model_axis > 1:
            lo, hi = dense_window(shape[0], model_axis, model_index)
            shape = (hi - lo,)

        def z():
            return torch.zeros(shape, dtype=torch.float32, device=device)
        return ServerState(z(), z())


def dense_window(d: int, n: int, index: int) -> tuple:
    """[lo, hi): model rank ``index``'s window of ``d`` coordinates split
    over ``n`` ranks, ceil(d/n) each and the last ones short (empty
    where the windows run past d)."""
    per = -(-int(d) // int(n))
    lo = min(int(index) * per, int(d))
    return lo, min(lo + per, int(d))


def gather_window(win: torch.Tensor, d: int, axis) -> torch.Tensor:
    """The (d,) vector from the model ranks' ``dense_window`` pieces:
    each padded to ceil(d/M), one all-gather over ``axis``, the padding
    cut off."""
    per = -(-int(d) // axis.size)
    if win.shape[0] < per:
        win = torch.cat([win, win.new_zeros(per - win.shape[0])])
    return axis.all_gather(win).reshape(-1)[:d]


def fold_row_chunks(chunks) -> torch.Tensor:
    """Reassemble the (r, c) table from its dequantized row chunks
    (``--overlap_depth``) in emission order. The chunks cover disjoint
    row ranges, so the fold is concatenation, with no summation; one
    chunk is the table itself (no copy)."""
    chunks = list(chunks)
    return chunks[0] if len(chunks) == 1 else torch.cat(chunks, dim=0)


def staleness_weights(staleness: torch.Tensor, alpha: float) -> torch.Tensor:
    """The asynchronous rounds' staleness discount ``(1 + s)^-alpha``
    in f32 (reference core/server.py:102), applied to a folded client's
    transmit and to its datapoint count, so the fold stays a weighted
    per-datapoint mean. The round skips it at alpha == 0."""
    return (1.0 + staleness.to(torch.float32)) ** (-float(alpha))


class ServerUpdate(NamedTuple):
    # subtract from ps_weights (already lr-scaled); None on the sparse
    # re-sketch branch, where ``support`` carries the update
    weight_update: Optional[torch.Tensor]
    state: ServerState
    # true_topk: (d,) bool, True where nothing was sent, for the
    # momentum factor masking of the participating clients' local
    # velocities; None for the other modes
    client_velocity_keep: Optional[torch.Tensor] = None
    # the coordinates the lr-scaled update changes: {"bitmap": the
    # packed (update * lr != 0) mask} (ops/vec.py packbits, the
    # threshold-select paths), or ((k,) indices, (k,) lr-scaled
    # values), of which those with a nonzero value; None for a dense
    # update (the caller decides, runtime/fed_model.py). On the device,
    # made with no host read; download accounting reads only these
    support: object = None
    # probes=True: {update_norm, momentum_norm, residual_norm and, for
    # the selecting modes, mass_coverage}, 0-dim tensors on the device
    probes: Optional[dict] = None


def _lr_scaled_support(idx, vals, lr):
    """Support of the weight update: its values scaled by the (scalar
    or per-coordinate) LR, gathered at the indices, so a coordinate
    whose LR is 0 reads as unchanged, as a value-compare on ``update *
    lr`` would."""
    return idx, vals * (lr[idx] if lr.ndim else lr)


def _l2(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x))


def _coverage(selected_mass, dense_mass) -> torch.Tensor:
    """‖selected‖² / ‖dense‖²: the share of the pre-selection vector's
    energy the sent support carries; a zero denominator (cold buffers)
    reads as full coverage."""
    return torch.where(dense_mass > 0,
                       selected_mass / torch.clamp(dense_mass, min=1e-30),
                       torch.ones_like(dense_mass))


def _state_probes(update_norm, state: ServerState, extra=None) -> dict:
    pr = {"update_norm": update_norm,
          "momentum_norm": _l2(state.Vvelocity),
          "residual_norm": _l2(state.Verror)}
    if extra:
        pr.update(extra)
    return pr


def server_update(cfg: Config, gradient: torch.Tensor, state: ServerState,
                  lr: torch.Tensor, sketch: Optional[CountSketch] = None,
                  noise_gen: Optional[torch.Generator] = None,
                  probes: bool = False) -> ServerUpdate:
    """Dispatch on mode (reference ``server_update``). For fedavg the
    caller passes lr = 1: the clients' local SGD applied the LR.
    ``noise_gen`` is the step's server noise stream (``--do_dp
    --dp_mode server``, uncompressed). ``probes=True`` also fills
    ``ServerUpdate.probes``: ``update_norm`` (of the lr-scaled update),
    ``residual_norm`` and ``momentum_norm`` (of the new Verror and
    Vvelocity, table space in sketch mode) and, for true_topk and
    sketch, ``mass_coverage`` (the selected support's energy over the
    pre-selection error's, sketch mode estimating the denominator by
    ``l2estimate``). Probes off computes none of them."""
    helper = {
        "sketch": _sketched,
        "local_topk": _local_topk,
        "true_topk": _true_topk,
        "fedavg": _fedavg,
        "uncompressed": _uncompressed,
    }[cfg.mode]
    return helper(cfg, gradient, state, lr, sketch, noise_gen, probes)


def _fedavg(cfg, avg_update, state, lr, sketch, noise_gen=None,
            probes=False):
    """``avg_update`` is the data-weighted mean of the clients' weight
    deltas, their LR already applied."""
    assert cfg.error_type == "none" and cfg.local_momentum == 0
    Vvel = avg_update + cfg.virtual_momentum * state.Vvelocity
    new_state = ServerState(Vvel, state.Verror)
    pr = _state_probes(_l2(Vvel), new_state) if probes else None
    return ServerUpdate(Vvel, new_state, probes=pr)


def _uncompressed(cfg, gradient, state, lr, sketch, noise_gen=None,
                  probes=False):
    Vvel = gradient + cfg.virtual_momentum * state.Vvelocity
    if cfg.do_dp and cfg.dp_mode == "server" and cfg.noise_multiplier != 0:
        assert noise_gen is not None, \
            "server-mode DP with noise needs a noise generator"
        # the reference adds the noise in place on Vvelocity, so it
        # stays in the momentum buffer
        Vvel = Vvel + gaussian_noise(noise_gen, Vvel.shape, Vvel.dtype,
                                     std=cfg.noise_multiplier)
    new_state = ServerState(Vvel, state.Verror)
    pr = _state_probes(_l2(Vvel * lr), new_state) if probes else None
    return ServerUpdate(Vvel * lr, new_state, probes=pr)


def _true_topk(cfg, gradient, state, lr, sketch, noise_gen=None,
               probes=False):
    """Virtual momentum and error in the dense space, exact top-k of
    the error sent; error feedback and momentum factor masking where
    it was sent."""
    from commefficient_tpu_torch.ops.topk import (threshold_topk_mask_1d,
                                                  topk_with_support,
                                                  use_threshold_select)
    assert cfg.error_type == "virtual"
    Vvel = gradient + cfg.virtual_momentum * state.Vvelocity
    Verr = state.Verror + Vvel
    k = min(cfg.k, cfg.grad_size)
    # under --approx_topk the reference selects by index (its
    # approx_max_k); the port's index selection is the exact set
    if use_threshold_select(k, cfg.grad_size, cfg.approx_topk):
        # the dense update's support is the value-compare of the
        # lr-scaled update, packed on the device (reference
        # core/server.py:242)
        mask = threshold_topk_mask_1d(Verr * Verr, k)
        update = torch.where(mask, Verr, torch.zeros_like(Verr))
        support = {"bitmap": packbits((update * lr) != 0)}
    else:
        update, idx, vals = topk_with_support(Verr, k)
        support = _lr_scaled_support(idx, vals, lr)
    dense_mass = torch.sum(Verr * Verr) if probes else None
    keep = update == 0
    zero = torch.zeros((), dtype=torch.float32, device=Verr.device)
    state = ServerState(torch.where(keep, Vvel, zero),
                        torch.where(keep, Verr, zero))
    pr = None
    if probes:
        pr = _state_probes(
            _l2(update * lr), state,
            {"mass_coverage": _coverage(torch.sum(update * update),
                                        dense_mass)})
    return ServerUpdate(update * lr, state, keep, support, probes=pr)


def _local_topk(cfg, local_topk_grad, state, lr, sketch, noise_gen=None,
                probes=False):
    """Momentum only: the clients sent a sparse quantity, so there is
    no virtual error, and masking the virtual momentum would zero all
    of it."""
    assert cfg.error_type in ("local", "none")
    Vvel = local_topk_grad + cfg.virtual_momentum * state.Vvelocity
    new_state = ServerState(Vvel, state.Verror)
    pr = _state_probes(_l2(Vvel * lr), new_state) if probes else None
    return ServerUpdate(Vvel * lr, new_state, probes=pr)


def _sketched(cfg: Config, sketched_grad: torch.Tensor,
              state: ServerState, lr: torch.Tensor,
              sketch: CountSketch, noise_gen=None,
              probes: bool = False) -> ServerUpdate:
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
    support = None
    # the pre-mask residual's energy for the coverage probe: the dense
    # residual never exists in sketch mode, so it is the table's own
    # median-of-rows l2estimate
    dense_mass = (torch.square(CountSketch.l2estimate(Verr)) if probes
                  else None)
    if sketch.prefer_threshold_unsketch(cfg.k):  # implies not sparse
        update, _ = sketch.unsketch_dense_mask(Verr, k=cfg.k)
        sel_mass = torch.sum(update * update) if probes else None
    else:
        update, idx, vals = sketch.unsketch(Verr, k=cfg.k,
                                            with_support=True,
                                            with_dense=not sparse)
        support = _lr_scaled_support(idx, vals, lr)
        sel_mass = torch.sum(vals * vals) if probes else None

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
    pr = None
    if probes:
        # the sparse branch never makes the dense update: its norm is
        # the lr-scaled support's
        pr = _state_probes(
            _l2(support[1]) if sparse else _l2(update * lr), state,
            {"mass_coverage": _coverage(sel_mass, dense_mass)})

    if sparse:
        return ServerUpdate(None, state, support=support, probes=pr)
    weight_update = update * lr
    if support is None:
        # the threshold path's support: the value-compare of the
        # lr-scaled update, packed on the device (reference
        # core/server.py:318)
        support = {"bitmap": packbits(weight_update != 0)}
    return ServerUpdate(weight_update, state, support=support, probes=pr)


def _psum_l2(x: torch.Tensor, axis) -> torch.Tensor:
    """The l2 norm of a vector sharded over a mesh axis."""
    return torch.sqrt(axis.psum(torch.sum(x * x).reshape(1))[0])


def uncompressed_update_2d(cfg: Config, gradient: torch.Tensor,
                           state: ServerState, lr: torch.Tensor,
                           noise_gen: Optional[torch.Generator], axis,
                           probes: bool = False) -> ServerUpdate:
    """The uncompressed server step of one model rank on the 2-D mesh
    (reference ``_build_server_round_2d_dense``, core/rounds.py:1477-1505,
    which XLA partitions along its sharding constraints): ``gradient``
    is the whole (d,) aggregate (replicated: summed over ``clients``),
    the momentum and error are this rank's ``dense_window`` of the
    coordinates, and ``_uncompressed``'s update runs on the window. The
    step is elementwise in d, so each window holds the one-device
    step's bits. The server DP noise is the one-device draw's window
    (the whole (d,) drawn from the step's stream), a per-coordinate LR
    its window. The lr-scaled update is all-gathered over ``axis`` (the
    ``model`` axis) into the (d,) vector every rank subtracts; the
    probes' norms sum their squares over ``axis``."""
    assert cfg.mode == "uncompressed", cfg.mode
    d = gradient.shape[0]
    lo, hi = dense_window(d, axis.size, axis.index)
    Vvel = gradient[lo:hi] + cfg.virtual_momentum * state.Vvelocity
    if cfg.do_dp and cfg.dp_mode == "server" and cfg.noise_multiplier != 0:
        assert noise_gen is not None, \
            "server-mode DP with noise needs a noise generator"
        noise = gaussian_noise(noise_gen, (d,), Vvel.dtype,
                               std=cfg.noise_multiplier)
        Vvel = Vvel + noise[lo:hi]
    upd = Vvel * (lr[lo:hi] if lr.ndim else lr)
    new_state = ServerState(Vvel, state.Verror)
    pr = None
    if probes:
        pr = {"update_norm": _psum_l2(upd, axis),
              "momentum_norm": _psum_l2(Vvel, axis),
              "residual_norm": _psum_l2(state.Verror, axis)}
    return ServerUpdate(gather_window(upd, d, axis), new_state, probes=pr)


def sketched_update_2d(cfg: Config, sketch: CountSketch,
                       sketched_grad_loc: torch.Tensor, state: ServerState,
                       lr: torch.Tensor, axis,
                       probes: bool = False) -> ServerUpdate:
    """The FetchSGD server step of one model peer on the 2-D mesh
    (reference ``sketched_update_2d``, core/server.py:364-470): the
    aggregate, momentum and error are this peer's (r, c/M) column
    shards of the tables (``axis``: the ``model`` axis, parallel/mesh.py),
    so the accumulation runs on 1/M of the state. The full table is
    gathered once; the peer estimates only its contiguous ceil(d/M)
    slice of the coordinates (kernel 2 over the window), the global
    k-th key is agreed through the all-reduced counts of each radix
    pass and the ties are taken in global index order
    (``distributed_threshold_mask_1d``); each peer compacts its winners
    into k slots with no host read, the M·k (index, value) slots are
    gathered and the first k valid ones are the update's support, in
    ascending order. The set is the one-card selection's. The update is
    re-sketched sparsely (as the reference's, whatever d) and a bucket
    of this peer's columns is kept where no selected coordinate landed.
    The dense update, the support and the probes come out the same on
    every peer."""
    from commefficient_tpu_torch.ops.topk import (
        compact_mask, distributed_threshold_mask_1d)
    from commefficient_tpu_torch.parallel.wire import gather_columns
    assert cfg.error_type in ("none", "virtual", "local")
    if cfg.error_type == "local":
        assert cfg.virtual_momentum == 0
    elif cfg.error_type == "virtual":
        assert cfg.local_momentum == 0
    d = cfg.grad_size
    k = min(cfg.k, d)
    Vvel = sketched_grad_loc + cfg.virtual_momentum * state.Vvelocity
    if cfg.error_type == "local":
        Verr = Vvel
    elif cfg.error_type == "virtual":
        Verr = state.Verror + Vvel
    else:  # "none": zero updates forever, as the one-device server
        Verr = state.Verror

    table = gather_columns(Verr, axis)
    # this peer's coordinates [start, start + n_loc); the tail shard's
    # slots at and past d are kept out of the population
    n_loc = -(-d // axis.size)
    start = axis.index * n_loc
    lo = min(start, sketch._padded_d)
    hi = min(start + n_loc, sketch._padded_d)
    est = sketch.estimates_window(table, lo, hi)  # zero at and past d
    if hi - lo < n_loc:
        est = torch.cat([est, est.new_zeros(n_loc - (hi - lo))])
    n_valid = max(0, min(n_loc, d - start))
    take = distributed_threshold_mask_1d(est * est, k, axis, n_valid)
    # candidates: this peer's winners in k slots (index d = empty),
    # all M·k slots gathered, the first k valid ones kept
    pos = compact_mask(take, k)
    n_take = torch.sum(take, dtype=torch.int64)
    ok = torch.arange(k, device=est.device) < n_take
    cand_idx = torch.where(ok, start + pos, torch.full_like(pos, d))
    cand_val = torch.where(ok, est[torch.clamp(pos, max=n_loc - 1)],
                           torch.zeros((), device=est.device))
    cand_idx = axis.all_gather(cand_idx).reshape(-1)
    cand_val = axis.all_gather(cand_val).reshape(-1)
    sel = compact_mask(cand_idx < d, k)
    idx = cand_idx[sel]  # ascending global order
    vals = cand_val[sel]

    dense_mass = (torch.square(CountSketch.l2estimate(table)) if probes
                  else None)
    update = torch.zeros(d, dtype=torch.float32, device=est.device)
    # unchecked indices (in range by construction): the public
    # index_put_ reads their range back to the host
    torch.ops.aten._index_put_impl_(update, (idx,), vals, True, True)
    support = _lr_scaled_support(idx, vals, lr)

    st = sketch.sketch_sparse(idx, vals)
    c_loc = Verr.shape[1]
    keep = st[:, axis.index * c_loc:(axis.index + 1) * c_loc] == 0
    zero = torch.zeros((), dtype=torch.float32, device=Verr.device)
    if cfg.error_type == "virtual":
        Verr = torch.where(keep, Verr, zero)
    Vvel = torch.where(keep, Vvel, zero)
    if cfg.error_type == "local":
        Verr = Vvel
    new_state = ServerState(Vvel, Verr)
    pr = None
    if probes:
        pr = {"update_norm": _l2(update * lr),
              "momentum_norm": _psum_l2(Vvel, axis),
              "residual_norm": _psum_l2(Verr, axis),
              "mass_coverage": _coverage(torch.sum(vals * vals),
                                         dense_mass)}
    return ServerUpdate(update * lr, new_state, support=support, probes=pr)
