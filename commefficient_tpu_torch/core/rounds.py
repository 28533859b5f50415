"""The federated round: client half and server half.

Port of the single-device paths of ``commefficient_tpu/core/rounds.py``:
the per-client state (``ClientStates`` :42, ``_state_ids`` :1179, its
row scatter :1194), the plan predicates (``resolve_rot_lanes`` :97,
``sketch_is_late`` :128, ``fused_grad_eligible`` :138, ``round_plan``
:153, ``args2sketch`` :218), the client round (``client_round`` :766:
the fused path of ``_fused_local`` :500, with its quantized wire
crossing ``_qdq_local`` / ``_qdq_local_overlapped`` :407-425, the
per-client path of ``_build_sgd_client_step`` :1200 and
``_build_fedavg_client_step`` :1247, and ``--client_chunk``'s
``_client_round_chunked`` :914) and the server round
(``build_server_round`` :1340, with the k-sized scatter of the sparse
re-sketch branch and true_topk's masking of client velocities).
The per-client round also carries the reference's robust folds
(``--robust_agg``, core/robust.py, in place of the sum :860-863), the
``transmit_transform`` hook on the per-client transmit stack (:287-292,
applied at :811), and ``--dp sketch``'s release (:857-888): the fold
divided by the static W·B capacity, the table emitted at f32, one noise
draw on the aggregated table, then the one wire qdq of the noisy table.
The fused round's weight-decay share under ``--dropout_prob``
(:548-563) is the round's alive fraction of its datapoints. The
asynchronous rounds' staleness-weighted fold (``client_weights``,
:238-330, 501-562, 620-631, 820-864) weights each client's transmit and
datapoint count by ``(1 + staleness)^-alpha``. The schema-v2 probes
(``probes=``/``probe_recovery=``, :235-296; ``_agg_probes`` :1047,
``_client_norm_stats`` :1059, the recovery error's dense ground truth
:642-764, 891-912, 975-1042; the server's through
``build_server_round(probes=)``, :1340) are 0-dim tensors on the
device; a round built without them is the plain round. On a mesh
(``mesh=``, parallel/mesh.py; reference ``client_round_fused`` :625-740,
``_partial_table_emit`` :426-500 and ``build_server_round``'s 2-D
dispatch :1340-1380, 1428-1475) the fused round runs each rank's slice
of the clients and crosses the table once, and a model axis shards the
server's state (the sketch server's columns, the dense server's
windows of coordinates, :1477-1505); the per-client round (reference
``client_round`` :766 under its client-sharded jit) runs a rank's slots
with their state rows from their owners (parallel/rows.py), or under
the host store with the rows its runtime gathered, and folds across
the mesh.

Batch layout: a dict of (W, B, ...) tensors with a (W, B) float "mask"
marking real samples. Where no per-client transform touches the
gradient (``fused_grad_eligible``) the client round runs ONE
forward/backward over all W·B samples: the aggregated quantity is the
gradient of the sample-weighted mean loss plus the weight-decay term,
sketched once (the FetchSGD linearity identity). Otherwise the clients
run as the reference runs them: all W in one batched pass
(``--client_chunk 0``, the reference's ``jax.vmap``), or ceil(W/C)
chunks of C (``--client_chunk C``, the last padded with dead slots).
A chunk gathers its clients' state rows once, runs their forward and
backward passes under ``torch.func.vmap``, then their sketches,
selections, momentum, error and clips on the (C, ...) stacks (the
kernels launch outside ``vmap``), and scatters the rows back once.
Transmits are summed within a chunk, then across chunks. Under
``--max_grad_norm`` or ``--robust_agg`` on a quantized wire each
client's table crosses the wire on its own. No device value is read on
the host.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.core.client import (accumulate_and_compress,
                                                 stale_weight_download)
from commefficient_tpu_torch.core.grad import (NoiseSlice, make_client_grad,
                                               make_forward_grad,
                                               map_clients, pad_samples,
                                               padded_to, worker_noise)
from commefficient_tpu_torch.core.robust import robust_fold
from commefficient_tpu_torch.core.server import (ServerState,
                                                 fold_row_chunks,
                                                 server_update,
                                                 sketched_update_2d,
                                                 staleness_weights,
                                                 uncompressed_update_2d)
from commefficient_tpu_torch.ops import quant
from commefficient_tpu_torch.ops.sketch import CountSketch
from commefficient_tpu_torch.parallel import rows as rowx
from commefficient_tpu_torch.parallel import wire as wirex
from commefficient_tpu_torch.parallel.mesh import (client_axis_size,
                                                   client_slice, is_sharded,
                                                   model_axis_size,
                                                   padded_rows)
from commefficient_tpu_torch.parallel.wire import row_chunks
from commefficient_tpu_torch.privacy.mechanism import (NOISE_TAG,
                                                       WORKER_NOISE_TAG,
                                                       add_table_noise,
                                                       noise_generator,
                                                       table_noise_std)


class ClientStates(NamedTuple):
    """Per-client persistent state, (num_clients + 1, ...) tensors on
    the device, updated in place by the client round. The last row is
    the dead-slot row: ``_state_ids`` sends a slot with an all-zero
    mask there, so its gathers and scatters touch no client's row
    (the reference's out-of-range sentinel, whose scatters drop).
    Fields a mode does not use are None. On a mesh (``init(mesh=)``,
    reference ``ClientStates.init(sharding=)``, core/rounds.py:51-75)
    a rank holds its ``clients`` block of ``padded_rows / C`` rows plus
    its own dead-slot row (parallel/rows.py), the same on its model
    peers."""
    velocities: Optional[torch.Tensor]  # (rows, *transmit_shape)
    errors: Optional[torch.Tensor]      # (rows, *transmit_shape)
    weights: Optional[torch.Tensor]     # (rows, grad_size), topk_down

    @staticmethod
    def init(cfg: Config, num_clients: int,
             ps_weights: Optional[torch.Tensor] = None,
             device="cuda", mesh=None) -> "ClientStates":
        rows = num_clients
        if mesh is not None:
            rows = padded_rows(num_clients, mesh) // client_axis_size(mesh)
        shape = (rows + 1,) + tuple(cfg.transmit_shape)

        def z():
            return torch.zeros(shape, dtype=torch.float32, device=device)

        vel = z() if cfg.local_momentum > 0 else None
        err = z() if cfg.error_type == "local" else None
        wts = None
        if cfg.do_topk_down:
            assert ps_weights is not None
            wts = ps_weights.detach().to(device, torch.float32)[None, :] \
                .repeat(rows + 1, 1)
        return ClientStates(vel, err, wts)


class RoundResult(NamedTuple):
    aggregated: torch.Tensor  # transmit-sum / total datapoints
    metrics: tuple            # per-client batch-mean metrics, each (W,)
    client_states: Optional[ClientStates] = None
    # --batchnorm: ({site path: (C,) sample-weighted mean of the
    # clients' batch statistics}, the round's real-sample count)
    bn_stats: Optional[tuple] = None
    # probes=True: {name: 0-dim tensor on the device}
    probes: Optional[dict] = None


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
    op touches the table: absent ``max_grad_norm``'s per-sketch clip
    and a robust fold, which needs every client's own table (the
    median of sketches)."""
    return (cfg.mode == "sketch" and cfg.max_grad_norm is None
            and cfg.robust_agg == "none")


def fused_grad_eligible(cfg: Config) -> bool:
    """Whether the round runs ONE backward of the sample-weighted mean
    loss (``Config.fused_grad``)."""
    return cfg.fused_grad


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
        "robust_agg": cfg.robust_agg,
        "overlap_depth": int(cfg.overlap_depth),
        "sketch_dtype": cfg.sketch_dtype,
        "downlink_encoding": cfg.downlink_encoding,
        "upload_wire_bytes_per_client": float(
            cfg.upload_wire_bytes_per_client),
    }
    if cfg.dp != "off":
        # enough to re-derive the accountant from the plan alone
        plan["dp"] = {"mode": str(cfg.dp),
                      "clip": float(cfg.dp_clip),
                      "noise_mult": float(cfg.dp_noise_mult),
                      "delta": float(cfg.dp_delta),
                      "epsilon_budget": float(cfg.dp_epsilon)}
    if cfg.mode == "sketch":
        plan["sketch"] = {"rows": int(cfg.num_rows),
                          "cols": int(cfg.num_cols),
                          "blocks": int(cfg.num_blocks),
                          "k": int(cfg.k),
                          "late": sketch_is_late(cfg),
                          "rot_lanes": resolve_rot_lanes(cfg)}
    if cfg.mode in ("true_topk", "local_topk"):
        plan["k"] = int(cfg.k)
    if cfg.autopilot == "on":
        # the knob-lattice walk (reference core/rounds.py:199-210):
        # enough to interpret and replay-check a ledger whose rounds
        # were dispatched through the variant cache
        from commefficient_tpu_torch.autopilot.lattice import (
            build_ladder, key_of, key_str)
        plan["autopilot"] = {
            "band": str(cfg.autopilot_band),
            "cooldown": int(cfg.autopilot_cooldown),
            "cache_size": int(cfg.autopilot_cache_size),
            "warm_ahead": bool(cfg.autopilot_warm_ahead),
            "pin": str(cfg.autopilot_pin or ""),
            "base": key_str(key_of(cfg)),
            "ladder": [key_str(k) for k in build_ladder(cfg)],
        }
    return plan


def args2sketch(cfg: Config) -> Optional[CountSketch]:
    if cfg.mode != "sketch":
        return None
    return CountSketch(d=cfg.grad_size, c=cfg.num_cols, r=cfg.num_rows,
                       num_blocks=cfg.num_blocks, seed=cfg.seed,
                       approx_topk=cfg.approx_topk,
                       approx_recall=cfg.approx_recall,
                       rot_lanes=resolve_rot_lanes(cfg))


def build_client_round(cfg: Config, loss_fn: Callable,
                       padded_batch_size: Optional[int] = None,
                       stats_fn: Optional[Callable] = None,
                       transmit_transform: Optional[Callable] = None,
                       dense_rows: bool = False,
                       client_weights: bool = False,
                       probes: bool = False,
                       probe_recovery: bool = False,
                       mesh=None) -> Callable:
    """Returns ``client_round(ps_weights, batch, client_states=None,
    client_ids=None, fedavg_lr=1.0, round_index=0, staleness=None,
    total=None, global_w=None) -> RoundResult``.

    ``mesh`` (parallel/mesh.py): ``batch`` is this rank's slice of the
    round's ``global_w`` clients (``mesh.client_slice``), ``total`` the
    WHOLE round's datapoint count (each rank's loss is normalised by it,
    reference core/rounds.py:628-631). The fused round splits the weight
    decay over the C client shards so their sum adds (wd/num_workers)·p
    once (:500-565); each rank sketches its local gradient once and the
    round all-reduces the table over ``clients`` (f32, or at wire width
    with ``n_addends = C``, in row chunks under ``--overlap_depth``); on
    the 2-D mesh each model peer sketches its ceil(d/M) coordinate slice
    (kernel 1 over the window), reduce-scatters the partial tables over
    ``model`` (quantized before the collective, headroom C·M) and
    all-reduces its (r, c/M) column shard over ``clients``: the
    aggregate leaves column-sharded. A probed round all-reduces the
    dense gradient too. The per-client round (reference
    core/rounds.py:766-912) reads ``client_states`` as this rank's
    block of the rows (``ClientStates.init(mesh=)``), its slots' rows
    crossing from and to their owners (parallel/rows.py), and folds
    across the mesh (``fold``); ``client_ids`` are its slots' ids. The
    metrics are gathered, so every rank holds all W. Where C does not
    divide W every rank runs all W clients and no table crosses (the
    2-D rank keeps its columns of the table).

    ``loss_fn(flat_params, batch) -> (loss, metrics)`` returns masked
    means over the last batch axis: per-client (W,) values for the
    whole (W, B, ...) batch (the fused path), scalars for one client's
    (B, ...) batch (the per-client path). ``padded_batch_size`` is B,
    which splits microbatches and fedavg's local batches (default
    ``--local_batch_size``, or 1 where that is -1). The per-client
    path reads and updates ``client_states`` (``ClientStates``, in
    place) at the rows of ``client_ids`` ((W,) int64 on the device);
    ``fedavg_lr`` is the LR of fedavg's local SGD. ``stats_fn(ps_weights,
    batch)`` (``--batchnorm``), where given, records every client's batch
    statistics at the round's weights; their sample-weighted mean rides
    on the result (``round_bn_stats``). ``round_index`` picks the
    round's noise streams (privacy/mechanism.py).

    ``transmit_transform(transmit, batch, client_ids, round_index) ->
    transmit``, where given, rewrites the (W, ...) per-client transmit
    stack before the fold (the chaos harness's byzantine hook,
    data/chaos.py, which no module of the round imports), with the
    round's real client ids; it forces the per-client round. At None
    nothing changes.

    ``dense_rows`` (the host client store, runtime/fed_model.py;
    reference core/rounds.py:268-273, 777-785): ``client_states`` holds
    only the round's W participant rows, ordered like ``client_ids``,
    plus the dead-slot row, so state rows are indexed by slot POSITION
    (``_state_ids`` of ``arange(W)``; dead slots still go to the
    dead-slot row), while ``transmit_transform`` keeps the real ids. On
    a mesh the rows are this rank's slots' and no row crosses in the
    round: the runtime's gather and write-back move them.

    ``client_weights`` (the asynchronous rounds, asyncfed/; reference
    core/rounds.py:238-330): the round takes ``staleness``, (W,) f32
    rounds each folded update waited, and weights each client's
    transmit and datapoint count by ``(1 + staleness)^-alpha``
    (``--async_staleness_weight``): the fused round weights each
    client's share of the loss and of the weight decay, the per-client
    round folds cw·transmit over Σ cw·n (over the static W·B under
    ``--dp sketch``; the robust folds take cw as their weights). At
    alpha == 0 the branch is not taken, so the round is the synchronous
    one, bit for bit.

    ``probes`` (``--probe_every``; reference core/rounds.py:235-296)
    fills ``RoundResult.probes`` with the aggregate's norm and NaN/Inf
    counts, and where per-client transmits exist their norms' alive
    mean, max and std, and the robust fold's ``fold_rejection_rate``.
    ``probe_recovery`` (sketch mode, the cadence rounds) adds
    ``recovery_error``, the sketch's top-k recovery against the dense
    aggregate: the fused round's gradient, the late sketch's dense sum
    (chunked: summed dense over the chunks, then sketched once); the
    clients' own tables (clip, robust) have none, and omit it. Without
    them nothing of the probes is computed."""
    round_fn = _build_client_round(cfg, loss_fn, padded_batch_size,
                                   transmit_transform, dense_rows,
                                   client_weights, probes, probe_recovery,
                                   mesh)
    if stats_fn is None:
        return round_fn

    def with_stats(ps_weights, batch, *args, **kw):
        res = round_fn(ps_weights, batch, *args, **kw)
        gw = kw.get("global_w")
        axis = (mesh.clients if mesh is not None and gw is not None
                and is_sharded(gw, mesh) else None)
        return res._replace(bn_stats=round_bn_stats(stats_fn, ps_weights,
                                                    batch, axis))

    return with_stats


def round_bn_stats(stats_fn: Callable, ps_weights: torch.Tensor,
                   batch: dict, axis=None) -> tuple:
    """Sample-weighted mean of the participating clients' batch
    statistics (reference ``_round_bn_stats``, core/rounds.py:1082):
    one extra forward over the round's clients, each normalized by its
    own batch; dead and padded clients weigh zero, and the round's
    sample count lets the server skip the blend of an empty round. On a
    sharded mesh round (``axis``, the ``clients`` axis) Σ nᵢ·sᵢ and Σ nᵢ
    are all-reduced, in one collective, before the division."""
    with torch.no_grad():
        n = torch.sum(batch["mask"], dim=-1)  # (W,)
        per_client = stats_fn(ps_weights, batch)
        if axis is None:
            w = n / torch.clamp(torch.sum(n), min=1.0)
            mean = {k: torch.tensordot(w.to(s.dtype), s, dims=([0], [0]))
                    for k, s in per_client.items()}
            return mean, torch.sum(n)
        keys = list(per_client)
        sums = [torch.tensordot(n.to(per_client[k].dtype), per_client[k],
                                dims=([0], [0])) for k in keys]
        flat = axis.psum(torch.cat([x.reshape(-1).to(torch.float32)
                                    for x in sums] + [torch.sum(n)[None]]))
        count = flat[-1]
        mean, off = {}, 0
        for k, x in zip(keys, sums):
            mean[k] = (flat[off:off + x.numel()].reshape(x.shape)
                       / torch.clamp(count, min=1.0)).to(x.dtype)
            off += x.numel()
    return mean, count


def _build_client_round(cfg: Config, loss_fn: Callable,
                        padded_batch_size: Optional[int],
                        transmit_transform: Optional[Callable],
                        dense_rows: bool = False,
                        client_weights: bool = False,
                        probes: bool = False,
                        probe_recovery: bool = False,
                        mesh=None) -> Callable:
    cfg.validate_runtime()
    # the recovery probe needs probes on and a sketch to recover from
    probe_recovery = bool(probes and probe_recovery
                          and cfg.mode == "sketch")
    if padded_batch_size is None:
        padded_batch_size = (cfg.local_batch_size
                             if cfg.local_batch_size > 0 else 1)
    if transmit_transform is not None:
        assert cfg.client_chunk == 0, \
            "transmit_transform needs the full per-client transmit " \
            "stack; incompatible with --client_chunk"
    # the staleness-weighted fold: at alpha == 0 every weight is 1, and
    # the branch is skipped
    alpha = float(cfg.async_staleness_weight)
    weighted = client_weights and alpha != 0.0
    if client_weights:
        assert cfg.client_chunk == 0, \
            "client_weights needs the full per-client transmit " \
            "stack; incompatible with --client_chunk"
    sketch = args2sketch(cfg)
    late = sketch_is_late(cfg)
    fused = fused_grad_eligible(cfg) and transmit_transform is None
    robust = cfg.robust_agg != "none"
    # --dp sketch: the noise lands on the f32 aggregated table, so the
    # tables cross at f32 and the round's one wire qdq runs on the
    # noisy table
    dp_on = cfg.dp == "sketch"
    noise_std = table_noise_std(cfg) if dp_on else 0.0
    noisy_workers = (cfg.do_dp and cfg.dp_mode == "worker"
                     and cfg.noise_multiplier != 0)
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
        if wire == "f32" or dp_on:
            return sketch.sketch(g)
        return fold_row_chunks(wire_crossing(g, rows) for rows in chunks)

    C, M = client_axis_size(mesh), model_axis_size(mesh)
    shard2d = M > 1 and cfg.mode == "sketch"

    def mesh_emit(g, wire=wire):
        """The sharded round's transmit and its crossings (reference
        ``_client_psum``, ``_partial_table_emit`` and, after the
        per-client round's local sum, ``_sketch_after_local_sum``): the
        table summed over ``clients`` (and on the 2-D mesh reduce-
        scattered over ``model`` first), f32 or at wire width."""
        if shard2d:
            n_loc = -(-cfg.grad_size // M)
            lo = min(mesh.model.index * n_loc, cfg.grad_size)
            partial = sketch.sketch_window(
                g, lo, min(lo + n_loc, cfg.grad_size))
            # quantized before the collective: headroom for the M
            # partials of the scatter times the C client shards
            return wirex.chunked_quantize_allreduce(
                wirex.local_rows(partial, wire), cfg.num_rows, wire,
                mesh.clients, C * M, cfg.overlap_depth, scatter=mesh.model,
                over=mesh.world)
        if cfg.mode != "sketch":
            return mesh.clients.psum(g.clone())
        if wire == "f32":
            produce = wirex.local_rows(sketch.sketch(g), wire)
        else:
            # kernel 4: each chunk's rows sketched and quantized at once
            def produce(rows):
                return sketch.sketch_quantized(g, wire, rows)
        return wirex.chunked_quantize_allreduce(
            produce, cfg.num_rows, wire, mesh.clients, C, cfg.overlap_depth)

    def fused_round(ps_weights, batch, client_states, staleness=None,
                    total=None, global_w=None):
        mask = batch["mask"]
        n = torch.sum(mask, dim=-1)
        cw = staleness_weights(staleness, alpha) if weighted else None
        sharded = (mesh is not None and global_w is not None
                   and is_sharded(global_w, mesh))
        if total is not None:
            # the whole round's datapoints (a mesh rank holds a slice)
            total = torch.as_tensor(total, dtype=torch.float32,
                                    device=mask.device)
        elif cw is not None:
            total = torch.clamp(torch.sum(cw * n), min=1.0)
        else:
            total = torch.clamp(torch.sum(mask), min=1.0)
        p = ps_weights.detach().requires_grad_(True)
        loss, metrics = loss_fn(p, batch)
        # all-padding clients: their (meaningless) loss must not
        # poison the weighted sum
        terms = torch.where(n > 0, loss * n, torch.zeros_like(loss))
        if cw is not None:
            # each client's term by its weight, against the weighted
            # total: the gradient is Σ cw_i·t_i / Σ cw_i·n_i
            terms = terms * cw
        (g,) = torch.autograd.grad(torch.sum(terms) / total, p)
        if cfg.weight_decay != 0:
            if cw is not None:
                # the weighted alive fraction: the per-client round's
                # Σ cw_i·n_i·(wd/num_workers)·p / total
                g = g + (wd_coef * (torch.sum(cw * n) / total)) * ps_weights
            elif cfg.dropout_prob > 0:
                # the round's alive fraction of its datapoints: the
                # whole term while any client is alive, exactly 0 on a
                # round whose clients all dropped, as the per-client
                # round's dead transmits are
                g = g + (wd_coef * (torch.sum(mask) / total)) * ps_weights
            elif sharded:
                # this shard's even share: the sum over the C shards
                # adds (wd/num_workers)·p once
                g = g + (wd_coef / C) * ps_weights
            else:
                g = g + wd_coef * ps_weights
        t = mesh_emit(g) if sharded else emit(g)
        mets = tuple(((n > 0) * m).detach()
                     for m in (loss,) + tuple(metrics))
        if sharded:
            # every rank holds the whole round's per-client metrics
            mets = tuple(mesh.clients.all_gather(m).reshape(-1)
                         for m in mets)
        # the whole table for the probes (a sharded 2-D aggregate is
        # this rank's columns)
        full = (wirex.gather_columns(t, mesh.model)
                if shard2d and sharded and probes else t)
        pr = None
        if probes:
            pr = _agg_probes(full)
            if probe_recovery:
                # the dense gradient is this round's own; on a
                # sharded round it crosses the clients axis too
                dense = mesh.clients.psum(g.clone()) if sharded else g
                pr["recovery_error"] = sketch.recovery_error(full, dense,
                                                             cfg.k)
        if shard2d and not sharded:
            # replicated: this rank's columns of the whole table
            cl = cfg.num_cols // M
            t = t[:, mesh.model.index * cl:(mesh.model.index + 1) * cl]
        return RoundResult(t, mets, client_states, probes=pr)

    if fused:
        return (lambda ps_weights, batch, client_states=None,
                client_ids=None, fedavg_lr=1.0, round_index=0,
                staleness=None, total=None, global_w=None:
                fused_round(ps_weights, batch, client_states, staleness,
                            total, global_w))

    if cfg.mode == "fedavg":
        per_client = _build_fedavg_client_step(cfg, loss_fn,
                                               padded_batch_size)
    else:
        # sketch late: each client sends its dense sum and the round
        # sketches the sum once (the linearity identity)
        step_cfg = (cfg.replace(mode="uncompressed", error_type="none")
                    if late else cfg)
        per_client = _build_sgd_client_step(step_cfg, loss_fn,
                                            None if late else sketch,
                                            padded_batch_size)

    def qdq(table):
        """One wire crossing at full range (the reference's
        ``_qdq_local``): quantize, then dequantize. Scales are per row,
        so a (C, r, c) stack crosses table by table, and an all-zero
        table stays exactly zero (the scale guard of ops/quant.py)."""
        return quant.dequantize(*quant.quantize_table(table, wire))

    # each client's table crosses the wire on its own where the clients
    # sketch (the clipped and robust paths; reference
    # core/rounds.py:814-821), except under DP
    per_client_wire = (wire != "f32" and cfg.mode == "sketch"
                       and not late and not dp_on)

    def run_chunk(ps_weights, client_states, ids, batch, fedavg_lr,
                  live=None, noise_gen=None, exchange=None):
        """The clients of one chunk (from ``live`` on, padding): gather
        their state rows, run the batched step, scatter the rows back;
        their (C, ...) transmits and (C,) metrics. On a mesh
        (``exchange``: the round's exchange ids, this rank's slots and
        whether the round is sharded) the rows cross the ``clients``
        axis from and to their owners (parallel/rows.py)."""
        if exchange is None:
            def take(a):
                return a.index_select(0, ids)

            def put(a, new):
                a.index_copy_(0, ids, new)
        else:
            all_ids, part, sharded = exchange

            def take(a):
                return rowx.gather_rows(a, all_ids, part, mesh.clients,
                                        sharded)

            def put(a, new):
                rowx.scatter_rows(a, all_ids, new, mesh.clients, sharded)
        rows = [None if a is None else take(a) for a in client_states]
        t, mets, *new_rows = per_client(ps_weights, *rows, batch,
                                        fedavg_lr, live, noise_gen)
        for arr, new in zip(client_states, new_rows):
            if arr is not None and new is not None:
                put(arr, new)
        return t, mets

    def release(aggregated, round_index):
        """``--dp sketch``'s release (reference core/rounds.py:874-888):
        one draw from the round's noise stream on the f32 aggregated
        table, then the deferred wire qdq of the noisy table, in the
        ``--overlap_depth`` row chunks."""
        gen = noise_generator(cfg.seed, round_index, NOISE_TAG,
                              aggregated.device)
        aggregated = add_table_noise(aggregated, gen, noise_std)
        if wire != "f32":
            aggregated = fold_row_chunks(qdq(aggregated[off:off + cnt])
                                         for off, cnt in chunks)
        return aggregated

    def everyone(x, sharded):
        """The whole round's (W, ...) per-client values on every rank:
        the ranks' slices all-gathered over ``clients`` in rank order,
        which is slot order."""
        if not sharded:
            return x
        return mesh.clients.all_gather(x).reshape((-1,) + tuple(x.shape[1:]))

    def fold(t, metrics, batch, cw, total, round_index, client_states,
             sharded):
        """The round's (W, ...) transmit stack (a sharded rank's W/C
        slice) folded into the aggregate, with the release, the metrics
        and the probes. On a sharded round a dense transmit or an early
        per-client table is summed locally and all-reduced at f32 over
        ``clients``, a late sketch crosses through ``mesh_emit``, and a
        robust fold runs on every rank over the all-gathered stack. On
        the 2-D mesh the aggregate leaves as this rank's table
        columns."""
        mask = batch["mask"]
        if per_client_wire:
            t = qdq(t)
        # the weighted fold scales each client's transmit; the robust
        # folds take the weights themselves
        t_fold = t if cw is None else t * _lead(cw, t)
        fold_pr = {} if probes else None
        # the aggregate is this rank's columns of the table (2-D)
        cols = False
        if robust:
            aggregated = robust_fold(cfg, everyone(t, sharded),
                                     {"mask": everyone(mask, sharded)},
                                     weights=(None if cw is None
                                              else everyone(cw, sharded)),
                                     probes=fold_pr)
        elif late and sharded:
            aggregated = mesh_emit(torch.sum(t_fold, dim=0),
                                   "f32" if dp_on else wire) / total
            cols = shard2d
        elif late:
            aggregated = emit(torch.sum(t_fold, dim=0)) / total
        else:
            aggregated = torch.sum(t_fold, dim=0)
            if sharded:
                aggregated = mesh.clients.psum(aggregated)
            aggregated = aggregated / total
        if dp_on:
            if cols:
                # the noise is the whole table's, as on one card
                aggregated = wirex.gather_columns(aggregated, mesh.model)
                cols = False
            aggregated = release(aggregated, round_index)
        metrics = tuple(everyone(m, sharded) for m in metrics)
        pr = None
        if probes:
            full = (wirex.gather_columns(aggregated, mesh.model) if cols
                    else aggregated)
            # the clients' norms are of what they sent, unweighted
            pr = _agg_probes(full)
            pr.update(_client_norm_stats(everyone(_row_norms(t), sharded),
                                         everyone(mask, sharded)))
            pr.update(fold_pr)
            if probe_recovery and late:
                dense = torch.sum(t_fold, dim=0)
                if sharded:
                    dense = mesh.clients.psum(dense)
                pr["recovery_error"] = sketch.recovery_error(
                    full, dense / total, cfg.k)
        if shard2d and not cols:
            # this rank's columns of the whole table
            cl = cfg.num_cols // M
            aggregated = aggregated[:, mesh.model.index * cl:
                                    (mesh.model.index + 1) * cl]
        return RoundResult(aggregated, metrics, client_states, probes=pr)

    def client_round(ps_weights, batch, client_states=None,
                     client_ids=None, fedavg_lr=1.0,
                     round_index=0, staleness=None, total=None,
                     global_w=None) -> RoundResult:
        mask = batch["mask"]
        W = mask.shape[0]
        cw = staleness_weights(staleness, alpha) if weighted else None
        sharded = (mesh is not None and global_w is not None
                   and is_sharded(global_w, mesh))
        # the round's clients: a sharded rank runs W/C of them
        round_w = global_w if sharded else W
        if dp_on:
            # the static padded capacity W·B of the WHOLE round: every
            # client's share of the release stays within the sqrt(r)·C/W
            # the accountant charges, on every round (reference
            # core/rounds.py:836-858)
            total = torch.full((), float(round_w * (mask.numel() // W)),
                               dtype=torch.float32, device=mask.device)
        elif total is not None:
            # the whole round's datapoints, Σ cw·n under the weighted
            # fold (a mesh rank holds a slice)
            total = torch.as_tensor(total, dtype=torch.float32,
                                    device=mask.device)
        elif cw is not None:
            # the weighted per-datapoint mean: Σ cw·transmit / Σ cw·n
            n = torch.sum(mask.reshape(W, -1), dim=1)
            total = torch.clamp(torch.sum(cw * n), min=1.0)
        else:
            total = torch.clamp(torch.sum(mask), min=1.0)
        if client_ids is None:
            client_ids = torch.zeros(W, dtype=torch.int64,
                                     device=mask.device)
        real_ids = client_ids
        if client_states is None:  # a mode with no per-client state
            client_states = ClientStates(None, None, None)
        gen = (noise_generator(cfg.seed, round_index, WORKER_NOISE_TAG,
                               mask.device) if noisy_workers else None)
        ids = exchange = None
        hook_kw = {}
        if mesh is not None:
            # the per-client round on a mesh (reference client_round
            # under its client-sharded jit, :766-912): this rank's slots,
            # the round's ids with the dead slots routed to no owner,
            # the hook's and the worker noise's draws the whole round's
            # with this rank's share kept; no chunks (reference :793)
            part = client_slice(round_w, mesh) if sharded else slice(0, W)
            if not dense_rows:
                alive = torch.sum(mask.reshape(W, -1), dim=1) > 0
                xids = rowx.exchange_ids(client_ids.to(mask.device), alive)
                exchange = (everyone(xids, sharded), part, sharded)
            hook_kw = {"slots": (part.start, round_w)}
            if gen is not None and sharded:
                gen = NoiseSlice(gen, part.start, round_w)
        if exchange is None:
            # one device, or the host store on a mesh, whose runtime
            # brought this rank's slots' rows (runtime/fed_model.py)
            dead = _dead_row(client_states)
            if dense_rows:
                # state rows are slot positions; the real ids stay in
                # real_ids
                client_ids = torch.arange(W, dtype=torch.int64,
                                          device=mask.device)
            ids = _state_ids(client_ids, batch, dead)
        chunk = cfg.client_chunk if mesh is None else 0
        if not 0 < chunk < W:
            # all W clients in one batched pass (reference client_round)
            t, metrics = run_chunk(ps_weights, client_states, ids,
                                   batch, fedavg_lr, noise_gen=gen,
                                   exchange=exchange)
            if transmit_transform is not None:
                t = transmit_transform(t, batch, real_ids, round_index,
                                       **hook_kw)
            return fold(t, metrics, batch, cw, total, round_index,
                        client_states, sharded)
        # ceil(W / chunk) chunks, the last padded with dead slots
        # (reference _client_round_chunked): transmits summed within a
        # chunk, then across chunks; under a late sketch each chunk's
        # dense sum is sketched and the tables summed
        n_chunks = -(-W // chunk)
        pad = n_chunks * chunk - W
        ids = torch.cat([ids, torch.full((pad,), dead, dtype=ids.dtype,
                                         device=ids.device)])
        batch = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
                 for k, v in batch.items()}
        acc, mets, norms = None, [], []
        for c in range(n_chunks):
            part = slice(c * chunk, (c + 1) * chunk)
            t, m = run_chunk(ps_weights, client_states, ids[part],
                             {k: v[part] for k, v in batch.items()},
                             fedavg_lr, live=min(chunk, W - c * chunk),
                             noise_gen=gen)
            if per_client_wire:
                t = qdq(t)
            if probes:
                norms.append(_row_norms(t))
            s = torch.sum(t, dim=0)
            if late and not probe_recovery:
                s = sketch.sketch(s)
            acc = s if acc is None else acc + s
            mets.append(m)
        dense_g = None
        if late and probe_recovery:
            # the probed round sums dense and sketches once (linearity:
            # the same table), keeping the recovery's ground truth
            dense_g = acc / total
            acc = sketch.sketch(acc)
        if late and wire != "f32":
            acc = qdq(acc)
        metrics = tuple(torch.cat(col)[:W] for col in zip(*mets))
        aggregated = acc / total
        pr = None
        if probes:
            pr = _agg_probes(aggregated)
            pr.update(_client_norm_stats(torch.cat(norms)[:W], mask))
            if dense_g is not None:
                pr["recovery_error"] = sketch.recovery_error(
                    aggregated, dense_g, cfg.k)
        return RoundResult(aggregated, metrics, client_states, probes=pr)

    return client_round


def _agg_probes(aggregated: torch.Tensor) -> dict:
    """The aggregate's norm and NaN/Inf element counts (reference
    ``_agg_probes``, core/rounds.py:1047)."""
    return {
        "agg_norm": torch.sqrt(torch.sum(aggregated * aggregated)),
        "agg_nan": torch.sum(torch.isnan(aggregated)).to(torch.float32),
        "agg_inf": torch.sum(torch.isinf(aggregated)).to(torch.float32),
    }


def _row_norms(transmit: torch.Tensor) -> torch.Tensor:
    """(C, ...) -> (C,) L2 norms of each client's transmit."""
    flat = transmit.reshape(transmit.shape[0], -1)
    return torch.sqrt(torch.sum(flat * flat, dim=1))


def _client_norm_stats(norms: torch.Tensor, mask: torch.Tensor) -> dict:
    """Mean, max and population std of the alive clients' transmit
    norms (reference ``_client_norm_stats``, core/rounds.py:1059); dead
    slots send zeros and are left out."""
    alive = (torch.sum(mask.reshape(mask.shape[0], -1), dim=1) > 0).to(
        torch.float32)
    n = torch.clamp(torch.sum(alive), min=1.0)
    mean = torch.sum(norms * alive) / n
    var = torch.sum(alive * torch.square(norms - mean)) / n
    return {"client_norm_mean": mean,
            "client_norm_max": torch.max(norms * alive),
            "client_norm_std": torch.sqrt(torch.clamp(var, min=0.0))}


def _dead_row(client_states: ClientStates) -> int:
    """Index of the dead-slot row (the last row of the state tensors;
    0 when the mode keeps no per-client state)."""
    arr = next((a for a in client_states if a is not None), None)
    return 0 if arr is None else arr.shape[0] - 1


def _state_ids(client_ids: torch.Tensor, batch: dict,
               dead_row: int) -> torch.Tensor:
    """Ids for per-client STATE gathers and scatters: a dead slot (an
    all-zero mask row) goes to ``dead_row``, so it can never alias a
    live client's row (reference ``_state_ids``, core/rounds.py:1179)."""
    mask = batch["mask"]
    alive = torch.sum(mask.reshape(mask.shape[0], -1), dim=1) > 0
    ids = client_ids.to(mask.device, torch.int64)
    return torch.where(alive, ids, torch.full_like(ids, dead_row))


def _lead(alive: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(C,) -> (C, 1, ...), broadcastable against ``like``."""
    return alive.reshape((-1,) + (1,) * (like.ndim - 1))


def _build_sgd_client_step(cfg, loss_fn, sketch, padded_batch_size):
    """A chunk of clients' round for every mode but fedavg (the
    reference worker's process_batch + local_step, one batched pass):
    ``step(ps_weights, velocity, error, client_weights, batch,
    fedavg_lr) -> (transmit, metrics, velocity, error,
    client_weights)``, the state and the transmits (C, ...) stacks;
    the rows from ``live`` on are padding, which selects nothing."""
    forward_grad = make_forward_grad(cfg, loss_fn, sketch,
                                     padded_batch_size)

    def step(ps_weights, velocity, error, client_weights, batch,
             fedavg_lr, live=None, noise_gen=None):
        del fedavg_lr
        mask = batch["mask"]
        batch_size = torch.sum(mask.reshape(mask.shape[0], -1), dim=1)
        alive = batch_size > 0
        if cfg.do_topk_down:
            weights = stale_weight_download(cfg, ps_weights,
                                            client_weights, live)
            # a dead slot did not download: its stale weights stay
            new_wts = torch.where(_lead(alive, weights), weights,
                                  client_weights)
        else:
            weights, new_wts = ps_weights, client_weights
        g_unit, metrics = forward_grad(weights, batch, noise_gen)
        upd = accumulate_and_compress(
            cfg, g_unit,
            velocity if cfg.local_momentum > 0 else None,
            error if cfg.error_type == "local" else None, batch_size,
            live)
        # a dead slot ran nothing: it sends 0 and its momentum and
        # error stay as they were
        ran = _lead(alive, upd.transmit)
        transmit = upd.transmit * ran.to(upd.transmit.dtype)

        def keep(new, old):
            if new is None or old is None:
                return old if new is None else new
            return torch.where(ran, new, old)

        return (transmit, metrics, keep(upd.velocity, velocity),
                keep(upd.error, error), new_wts)

    return step


def _build_fedavg_client_step(cfg, loss_fn, padded_batch_size):
    """A chunk of clients' FedAvg round, one batched pass: each runs
    local SGD over its whole (padded) dataset in batches of
    ``--fedavg_batch_size`` for ``--num_fedavg_epochs`` epochs, the LR
    decayed by ``--fedavg_lr_decay`` a step, and sends its weight
    delta times its sample count (the reference worker's fedavg
    loop). Under ``--do_dp --dp_mode worker`` every local step's
    gradient takes its own draw of the worker noise, drawn for all
    steps before the batched pass."""
    if cfg.fedavg_batch_size == -1:
        sub = padded_batch_size
    else:
        sub = min(cfg.fedavg_batch_size, padded_batch_size)
    n_batches = -(-padded_batch_size // sub)
    client_grad = make_client_grad(cfg, loss_fn, sub)
    n = padded_to(cfg, sub)

    def local_sgd(ps_weights, batch, fedavg_lr, noise=None):
        # batch: (n_batches, n, ...), the local batches; noise:
        # (epochs * n_batches, d) or None
        client_size = torch.sum(batch["mask"])
        w = ps_weights
        step_i = torch.zeros((), dtype=torch.float32,
                             device=ps_weights.device)
        sums = None
        for e in range(cfg.num_fedavg_epochs):
            for j in range(n_batches):
                mb = {k: v[j] for k, v in batch.items()}
                valid = torch.sum(mb["mask"]) > 0
                g_unit, metrics = client_grad(w, mb)
                if noise is not None:
                    g_unit = g_unit + noise[e * n_batches + j]
                # an all-padding batch changes nothing and is no step
                w_new = w - g_unit * fedavg_lr * (cfg.fedavg_lr_decay
                                                  ** step_i)
                w = torch.where(valid, w_new, w)
                step_i = step_i + valid.to(torch.float32)
                got = tuple(torch.where(valid, m, torch.zeros_like(m))
                            for m in metrics)
                sums = got if sums is None else tuple(
                    a + b for a, b in zip(sums, got))
        # metrics: the mean over the local steps taken
        n_steps = torch.clamp(step_i, min=1.0)
        metrics = tuple(m / n_steps for m in sums)
        return (ps_weights - w) * client_size, metrics

    def step(ps_weights, velocity, error, client_weights, batch,
             fedavg_lr, live=None, noise_gen=None):
        del live
        # (C, B, ...) -> (C, n_batches, n, ...): the local batches of
        # sub samples, each padded for its microbatches
        c = batch["mask"].shape[0]
        batch = pad_samples(batch, n_batches * sub)
        batch = pad_samples({k: v.reshape((c * n_batches, sub) + v.shape[2:])
                             for k, v in batch.items()}, n)
        batch = {k: v.reshape((c, n_batches) + v.shape[1:])
                 for k, v in batch.items()}
        noise = worker_noise(cfg, noise_gen,
                             (c, cfg.num_fedavg_epochs * n_batches,
                              ps_weights.shape[-1]))
        if noise is None:
            transmit, metrics = map_clients(
                lambda b: local_sgd(ps_weights, b, fedavg_lr), (0,),
                cfg.do_remat)(batch)
        else:
            transmit, metrics = map_clients(
                lambda b, z: local_sgd(ps_weights, b, fedavg_lr, z),
                (0, 0), cfg.do_remat)(batch, noise)
        return transmit, metrics, velocity, error, client_weights

    return step


def build_server_round(cfg: Config, probes: bool = False,
                       mesh=None) -> Callable:
    """Returns ``server_round(ps_weights, server_state, aggregated, lr,
    client_velocities=None, client_ids=None, noise_gen=None) ->
    (new_ps_weights,
    new_server_state, client_velocities, weight_update, support)``.
    ``support`` names the coordinates the update changed (download
    accounting): {"bitmap": the packed mask} on the threshold-select
    paths; ((k,) indices, (k,) lr-scaled values) on the index paths and
    the sparse re-sketch branch, where ``weight_update`` is None and
    the update is applied as a k-sized scatter instead of a dense (d,)
    subtraction; or None for a dense update (runtime/fed_model.py
    decides its form). ``lr`` is a scalar or a (d,) tensor of
    per-coordinate LRs on the device (index param groups). fedavg's
    server takes lr = 1 (the clients applied the LR). Under true_topk with
    local momentum, the participating clients' velocity rows
    (``client_ids``, dead slots at the dead-slot row) are zeroed where
    the server sent, in place. ``noise_gen`` is the step's server noise
    stream under ``--do_dp --dp_mode server``. ``probes=True`` appends
    a sixth output, the server's probe dict (core/server.py).

    ``mesh`` with a model axis of more than one rank: in sketch mode
    the model-sharded FetchSGD server (reference
    ``_build_server_round_2d_sketch``, core/rounds.py:1340-1380,
    1428-1475; core/server.py ``sketched_update_2d``): the aggregate and
    the state are this rank's (r, c/M) column shards, the dense update
    and the support come back the same on every rank; in uncompressed
    mode the dense server (reference ``_build_server_round_2d_dense``,
    :1477-1505; core/server.py ``uncompressed_update_2d``): the
    aggregate is whole, the state this rank's window of ceil(d/M)
    coordinates, the update all-gathered. Any other mesh runs the
    one-device server, the same on every rank."""
    cfg.validate_runtime()
    sketch = args2sketch(cfg)
    two_d = model_axis_size(mesh) > 1
    if two_d:
        # the config gate: a model axis shards sketch or uncompressed
        # state only (reference config.py:752-768)
        assert cfg.mode in ("sketch", "uncompressed"), cfg.mode

    def server_round(ps_weights: torch.Tensor, server_state: ServerState,
                     aggregated: torch.Tensor, lr, client_velocities=None,
                     client_ids=None, noise_gen=None):
        if isinstance(lr, torch.Tensor) and lr.ndim:
            # per-coordinate LRs (index param groups), on the device
            assert cfg.mode != "fedavg", "fedavg supports scalar lr only"
            lr = lr.to(ps_weights.device, torch.float32)
        else:
            # made on the device: a copy up would stop the host
            lr = torch.full((), 1.0 if cfg.mode == "fedavg" else float(lr),
                            dtype=torch.float32, device=ps_weights.device)
        if two_d:
            if cfg.mode == "sketch":
                res = sketched_update_2d(cfg, sketch, aggregated,
                                         server_state, lr, mesh.model,
                                         probes)
            else:
                res = uncompressed_update_2d(cfg, aggregated, server_state,
                                             lr, noise_gen, mesh.model,
                                             probes)
            out = (ps_weights - res.weight_update, res.state,
                   client_velocities, res.weight_update, res.support)
            return out + (res.probes,) if probes else out
        res = server_update(cfg, aggregated, server_state, lr, sketch,
                            noise_gen, probes)
        if res.weight_update is None:
            # the indices are sorted and unique (also under
            # --approx_topk: the selection is exact), so each
            # coordinate takes one subtraction: ps[idx] - scaled, as
            # the reference's ordered scatter-add of -scaled
            idx, scaled = res.support
            new_ps = ps_weights.clone()
            new_ps[idx] = ps_weights[idx] - scaled
        else:
            new_ps = ps_weights - res.weight_update
        if (cfg.mode == "true_topk" and cfg.local_momentum > 0
                and client_velocities is not None):
            assert client_ids is not None
            rows = client_velocities.index_select(0, client_ids)
            client_velocities.index_copy_(
                0, client_ids,
                rows * res.client_velocity_keep.to(rows.dtype))
        out = (new_ps, res.state, client_velocities, res.weight_update,
               res.support)
        return out + (res.probes,) if probes else out

    return server_round
