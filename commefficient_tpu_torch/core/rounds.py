"""The federated round: client half and server half.

Port of the single-device sketch-mode path of
``commefficient_tpu/core/rounds.py``: the plan predicates
(``resolve_rot_lanes`` :97, ``sketch_is_late`` :128,
``fused_grad_eligible`` :138, ``round_plan`` :153, ``args2sketch``
:218), the fused client round (``_fused_local`` :500 and the
single-device branch of ``client_round_fused`` :741, with its
quantized wire crossing ``_qdq_local`` / ``_qdq_local_overlapped``
:407-425 applied at :747-755) and the server round
(``build_server_round`` :1340, with the k-sized scatter of the sparse
re-sketch branch).

Batch layout: a dict of (W, B, ...) tensors with a (W, B) float "mask"
marking real samples. The client round runs ONE forward/backward over
all W·B samples: the aggregated quantity is the gradient of the
sample-weighted mean loss plus the weight-decay term, sketched once
(the FetchSGD linearity identity; no per-client gradient exists).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.server import (ServerState,
                                                 fold_row_chunks,
                                                 server_update)
from commefficient_tpu_torch.ops import quant
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.parallel.wire import row_chunks


class RoundResult(NamedTuple):
    aggregated: torch.Tensor  # transmit-sum / total datapoints
    metrics: tuple            # per-client batch-mean metrics, each (W,)


def resolve_rot_lanes(cfg: Config) -> int:
    """``--sketch_rot_lanes -1`` (auto) resolves to 0, full-granularity
    rotations: the reference engages quantized rotations only on a
    TPU backend, where they buy the Pallas kernels a single sublane
    roll; the Hopper kernels take any rotation at the same cost, so
    on the card (as on any non-TPU backend of the reference) auto is
    0. Explicit values pass through."""
    lanes = getattr(cfg, "sketch_rot_lanes", 0)
    return lanes if lanes >= 0 else 0


def sketch_is_late(cfg: Config) -> bool:
    """Sketching after the local dense sum is legal when no per-client
    op touches the table (the port has no per-sketch clip or robust
    fold, so every sketch-mode round qualifies)."""
    return cfg.mode == "sketch"


def fused_grad_eligible(cfg: Config) -> bool:
    """The aggregated quantity is exactly the gradient of the
    sample-weighted mean loss (one backward) when no per-client
    transform touches the gradient."""
    return (cfg.mode in ("sketch", "uncompressed", "true_topk")
            and cfg.local_momentum == 0 and cfg.error_type != "local")


def round_plan(cfg: Config) -> dict:
    """Static description of the round this Config builds."""
    plan = {
        "mode": cfg.mode,
        "error_type": cfg.error_type,
        "grad_size": int(cfg.grad_size),
        "num_workers": int(cfg.num_workers),
        "transmit_shape": list(cfg.transmit_shape),
        "upload_floats_per_client": int(cfg.upload_floats_per_client),
        "fused_grad": fused_grad_eligible(cfg),
        "overlap_depth": int(cfg.overlap_depth),
        "sketch_dtype": cfg.sketch_dtype,
        "downlink_encoding": cfg.downlink_encoding,
        "upload_wire_bytes_per_client": float(
            cfg.upload_wire_bytes_per_client),
    }
    if cfg.mode == "sketch":
        plan["sketch"] = {"rows": int(cfg.num_rows),
                          "cols": int(cfg.num_cols),
                          "blocks": int(cfg.num_blocks),
                          "k": int(cfg.k),
                          "late": sketch_is_late(cfg),
                          "rot_lanes": resolve_rot_lanes(cfg)}
    return plan


def args2sketch(cfg: Config) -> Optional[CountSketch]:
    if cfg.mode != "sketch":
        return None
    return CountSketch(d=cfg.grad_size, c=cfg.num_cols, r=cfg.num_rows,
                       num_blocks=cfg.num_blocks, seed=cfg.seed,
                       rot_lanes=resolve_rot_lanes(cfg))


def build_client_round(cfg: Config, loss_fn: Callable) -> Callable:
    """Returns ``client_round(ps_weights, batch) -> RoundResult``.

    ``loss_fn(flat_params, batch) -> (loss, metrics)`` takes the whole
    (W, B, ...) batch and returns per-client masked-mean values, each
    (W,)."""
    cfg.validate_runtime()
    if not fused_grad_eligible(cfg):
        raise NotImplementedError(
            "the per-client round path (local momentum/error, clip, "
            "DP, topk_down, microbatching) is not ported")
    sketch = args2sketch(cfg)
    # Σ_i (wd/num_workers)·p·n_i / total = (wd/num_workers)·p: one
    # device holds every client, so the whole term lands here
    wd_coef = cfg.weight_decay / cfg.num_workers
    # The quantized wire (--sketch_dtype): the table is emitted
    # quantized at full range per row, harmonized onto the shared scale
    # (the identity for the one addend of a single device) and
    # dequantized, the same bytes as the reference's _qdq_local of the
    # f32 table; under --overlap_depth N, in min(N, r) row chunks (per-row
    # scales: a chunk is its row slice of the whole), folded in order.
    # At f32 none of this runs.
    wire = cfg.sketch_dtype
    chunks = row_chunks(cfg.num_rows, cfg.overlap_depth)

    def wire_crossing(g, rows):
        q, rowmax = sketch.sketch_quantized(g, wire, rows)
        return quant.dequantize(*quant.harmonize(q, rowmax, rowmax,
                                                 wire, 1))

    def emit(g):
        if cfg.mode != "sketch":
            return g
        if wire == "f32":
            return sketch.sketch(g)
        return fold_row_chunks(wire_crossing(g, rows) for rows in chunks)

    def client_round(ps_weights: torch.Tensor, batch: dict) -> RoundResult:
        mask = batch["mask"]
        total = torch.clamp(torch.sum(mask), min=1.0)
        p = ps_weights.detach().requires_grad_(True)
        loss, metrics = loss_fn(p, batch)
        n = torch.sum(mask, dim=-1)
        # all-padding clients: their (meaningless) loss must not
        # poison the weighted sum
        weighted = torch.where(n > 0, loss * n, torch.zeros_like(loss))
        (g,) = torch.autograd.grad(torch.sum(weighted) / total, p)
        if cfg.weight_decay != 0:
            g = g + wd_coef * ps_weights
        t = emit(g)
        mets = tuple(((n > 0) * m).detach()
                     for m in (loss,) + tuple(metrics))
        return RoundResult(t, mets)

    return client_round


def build_server_round(cfg: Config) -> Callable:
    """Returns ``server_round(ps_weights, server_state, aggregated,
    lr) -> (new_ps_weights, new_server_state, weight_update,
    support)``; ``support`` holds the indices of the coordinates the
    update changed (download accounting), or on the sparse re-sketch
    branch ((k,) indices, (k,) lr-scaled values), where
    ``weight_update`` is None and the update is applied as a k-sized
    scatter instead of a dense (d,) subtraction."""
    cfg.validate_runtime()
    sketch = args2sketch(cfg)

    def server_round(ps_weights: torch.Tensor, server_state: ServerState,
                     aggregated: torch.Tensor, lr):
        lr = torch.as_tensor(lr, dtype=torch.float32,
                             device=ps_weights.device)
        res = server_update(cfg, aggregated, server_state, lr, sketch)
        if res.weight_update is None:
            # the indices are sorted and unique, so each coordinate
            # takes one subtraction: ps[idx] - scaled, as the
            # reference's ordered scatter-add of -scaled
            idx, scaled = res.support
            new_ps = ps_weights.clone()
            new_ps[idx] = ps_weights[idx] - scaled
        else:
            new_ps = ps_weights - res.weight_update
        return new_ps, res.state, res.weight_update, res.support

    return server_round
