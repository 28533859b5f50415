"""Rank functions of the port's mesh tests (tests/test_torch_mesh*.py,
tests/test_torch_wire_collectives.py).

``commefficient_tpu_torch.parallel.mesh.launch`` spawns the ranks, which
import this module to find their function: it imports torch and the
port only, never JAX, so a rank starts in a few seconds. Each function
runs inside a launched gloo group on the CPU and returns numpy arrays,
which the test (in the parent, beside JAX) compares.
"""

import numpy as np
import torch

from commefficient_tpu_torch.config import Config
from commefficient_tpu_torch.parallel import mesh as pm
from commefficient_tpu_torch.parallel import wire as wirex

WIRES = ("f32", "bf16", "int8", "fp8")


def _np(t):
    """A tensor as numpy; bf16 and fp8 as their raw bytes (uint16 /
    uint8), which numpy holds bit for bit."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e4m3fn:
        return t.view(torch.uint8).numpy()
    return t.numpy()


def topology(world, shape):
    """Each axis as this rank sees it, and the ranks of its groups in axis
    order (an all-gather of the world ranks over the axis)."""
    cfg = Config(device="cpu", num_devices=world,
                 mesh="" if shape is None else shape)
    mesh = pm.build_mesh(cfg)
    me = torch.tensor([mesh.rank])
    return {"rank": mesh.rank, "shape": mesh.shape,
            "clients": (mesh.clients.index, mesh.clients.size,
                        mesh.clients.all_gather(me).reshape(-1).tolist()),
            "model": (mesh.model.index, mesh.model.size,
                      mesh.model.all_gather(me).reshape(-1).tolist()),
            "slice8": (pm.client_slice(8, mesh).start,
                       pm.client_slice(8, mesh).stop),
            "sharded6": pm.is_sharded(6, mesh),
            "padded10": pm.padded_rows(10, mesh),
            "shape_dict": pm.mesh_shape_dict(mesh)}


def wire_crossings(tables, shape=None):
    """Every wire crossing of this rank's table ``tables[rank]`` over the
    mesh's axes: the all-reduce over ``clients`` of each wire, whole and
    in row chunks of --overlap_depth 2 and 3; on a 2-D mesh (``shape``),
    the reduce-scatter over ``model`` of each wire's table quantized with
    C·M headroom over the world, and the whole 2-D emission crossing
    (scatter over ``model``, all-reduce over ``clients``) whole and in 2
    row chunks; and the rowmax max."""
    cfg = Config(device="cpu", num_devices=len(tables), mesh=shape or "")
    mesh = pm.build_mesh(cfg)
    t = torch.from_numpy(tables[mesh.rank])
    c_ax, m_ax = mesh.clients, mesh.model
    out = {}
    for wire in WIRES:
        for depth in (1, 2, 3):
            out[("allreduce", wire, depth)] = _np(
                wirex.chunked_quantize_allreduce(
                    wirex.local_rows(t, wire), t.shape[0], wire, c_ax,
                    c_ax.size, depth))
        if wire != "f32":
            q, scale = wirex.quantize_for_collective(t, wire, c_ax,
                                                     c_ax.size)
            out[("harmonized", wire)] = _np(q)
            out[("wire_sum", wire)] = _np(
                wirex.quant.wire_psum(q, scale, c_ax)[0])
        if m_ax.size > 1:
            n = c_ax.size * m_ax.size
            for depth in (1, 2):
                # the 2-D emission's crossing as the round runs it
                out[("emit2d", wire, depth)] = _np(
                    wirex.chunked_quantize_allreduce(
                        wirex.local_rows(t, wire), t.shape[0], wire, c_ax,
                        n, depth, scatter=m_ax, over=mesh.world))
            if wire == "f32":
                out[("scatter", wire)] = _np(wirex.wire_reduce_scatter(
                    t, m_ax))
            else:
                q, scale = wirex.quantize_for_collective(t, wire,
                                                         mesh.world, n)
                out[("harmonized_world", wire)] = _np(q)
                out[("scatter", wire)] = _np(wirex.wire_reduce_scatter(
                    q, m_ax))
    rowmax = torch.amax(torch.abs(t), dim=-1, keepdim=True)
    out[("rowmax",)] = _np(wirex.quant.global_rowmax_over(rowmax,
                                                          mesh.world))
    return out


def select_shards(cases):
    """``distributed_threshold_mask_1d`` over the model axis of the 1xM
    launched mesh, for each (key shards, k, valid counts) of ``cases``:
    this rank's shard of each mask."""
    from commefficient_tpu_torch.ops.topk import \
        distributed_threshold_mask_1d
    mesh = pm.build_mesh(Config(device="cpu",
                                mesh=f"1x{len(cases[0][0])}"))
    p = mesh.model.index
    return [_np(distributed_threshold_mask_1d(
        torch.from_numpy(shards[p]), k, mesh.model, n_valids[p]))
        for shards, k, n_valids in cases]


def linear_loss(p, batch):
    """The reference tests' masked-mean MSE of y = w.x, per client of a
    (W, B, d) round batch (the fused round's loss)."""
    pred = batch["x"] @ p
    sq = (pred - batch["y"]) ** 2
    n = torch.clamp(torch.sum(batch["mask"], -1), min=1.0)
    loss = torch.sum(sq * batch["mask"], -1) / n
    return loss, (loss * 0.0 + 1.0,)


def linear_rounds(cfg_kw, batches, ps0, lr=0.01):
    """Chained rounds of ``build_client_round``/``build_server_round`` on
    ``linear_loss`` over this rank's mesh (``cfg_kw``'s --num_devices /
    --mesh; none: one device): per round the aggregate (this rank's
    column shard on a model axis) and the weights, and the final server
    state."""
    from commefficient_tpu_torch.core.rounds import (build_client_round,
                                                     build_server_round)
    from commefficient_tpu_torch.core.server import ServerState
    cfg = Config(device="cpu", **cfg_kw)
    mesh = pm.build_mesh(cfg)
    cr = build_client_round(cfg, linear_loss, batches[0]["x"].shape[1],
                            mesh=mesh)
    sr = build_server_round(cfg, mesh=mesh)
    ps = torch.from_numpy(ps0)
    ss = ServerState.init(cfg, "cpu", pm.model_axis_size(mesh),
                          0 if mesh is None else mesh.model.index)
    aggs, weights = [], []
    for b in batches:
        w = b["mask"].shape[0]
        part = pm.client_slice(w, mesh)
        batch = {k: torch.from_numpy(v[part]) for k, v in b.items()}
        kw = ({} if mesh is None else
              dict(total=max(float(b["mask"].sum()), 1.0), global_w=w))
        res = cr(ps, batch, **kw)
        ps, ss, _, _, _ = sr(ps, ss, res.aggregated, lr)
        aggs.append(_np(res.aggregated))
        weights.append(_np(ps))
    return {"rank": 0 if mesh is None else mesh.rank, "aggs": aggs,
            "weights": weights, "Vvelocity": _np(ss.Vvelocity),
            "Verror": _np(ss.Verror),
            "model": (0, 1) if mesh is None else (mesh.model.index,
                                                  mesh.model.size)}


def resnet9_rounds(configs, flat, channels, batches, num_clients, lr):
    """Chained rounds of the ResNet9 cell through ``FedModel`` /
    ``FedOptimizer`` on this rank's mesh, for each of ``configs`` (Config
    keyword dicts with --num_devices), from the flat weights ``flat``:
    per round the aggregate, the weights, the metrics (every client's)
    and the byte totals."""
    from commefficient_tpu_torch.models.resnet9 import ResNet9
    from commefficient_tpu_torch.runtime.fed_model import (FedModel,
                                                           FedOptimizer)
    from commefficient_tpu_torch.train.cv_train import make_compute_loss
    out = []
    for kw in configs:
        cfg = Config(device="cpu", num_clients=num_clients,
                     dataset_name="Synthetic", **kw)
        module = ResNet9(num_classes=10, channels=channels)
        model = FedModel(module, torch.from_numpy(flat),
                         make_compute_loss(module), cfg)
        opt = FedOptimizer([{"lr": lr}], cfg)
        rounds = []
        for b in batches:
            met = model(dict(b))
            agg = _np(model.pending_aggregated)
            opt.step()
            rounds.append({"agg": agg, "ps": _np(model.ps_weights),
                           "loss": met[0], "down": met[-2], "up": met[-1],
                           "last_updated": model.last_updated.copy()})
        out.append({"rank": model.rank, "rounds": rounds,
                    "state_shape": tuple(opt.server_state.Verror.shape)})
    return out


def trainer_main(argv):
    """``cv_train.main(argv)`` in a rank (the ranks' results; the
    trainer's own launch returns rank 0's)."""
    from commefficient_tpu_torch.train import cv_train
    return cv_train.main(argv)


def _state_block(model):
    """This rank's owned state rows (the dead-slot row left out) and its
    first row's client id."""
    cs = model.client_states
    # copies: the round updates the rows in place
    block = {name: _np(arr[:-1]).copy() for name, arr in
             (("velocities", cs.velocities), ("errors", cs.errors),
              ("weights", cs.weights)) if arr is not None}
    per = next((a.shape[0] for a in block.values()), 0)
    lo = 0 if model.mesh is None else model.mesh.clients.index * per
    return lo, block


def _fed_model(kind, cfg, flat, spec, padded_batch_size):
    """The port's FedModel and FedOptimizer of the ResNet9 cell
    (``spec`` its channels) or of GPT-2 (``spec`` its GPT2Config
    keywords) on ``flat``."""
    from commefficient_tpu_torch.runtime.fed_model import (FedModel,
                                                           FedOptimizer)
    if kind == "gpt2":
        from commefficient_tpu_torch.models.gpt2 import (GPT2Config,
                                                         GPT2DoubleHeads)
        from commefficient_tpu_torch.train.gpt2_train import \
            make_compute_loss_train
        module = GPT2DoubleHeads(GPT2Config(**spec))
        model = FedModel(module, torch.from_numpy(flat),
                         make_compute_loss_train(module, cfg, True), cfg,
                         padded_batch_size=padded_batch_size)
    else:
        from commefficient_tpu_torch.models.resnet9 import ResNet9
        from commefficient_tpu_torch.train import cv_train
        module = ResNet9(num_classes=10, channels=spec,
                         do_batchnorm=cfg.do_batchnorm)
        extra = {}
        if cfg.do_batchnorm:
            extra = dict(stats_fn=cv_train.make_bn_stats_fn(module),
                         init_model_state=module.init_state())
        model = FedModel(module, torch.from_numpy(flat),
                         cv_train.make_compute_loss(module), cfg,
                         padded_batch_size=padded_batch_size, **extra)
    return model, FedOptimizer([{"lr": 1.0}], cfg)


def client_rounds(kind, configs, spec, num_clients, lr):
    """Chained rounds of the ResNet9 cell or of GPT-2 (``kind``) through
    ``FedModel`` / ``FedOptimizer`` on this rank's mesh (or on one
    device, outside a launched group), for each ``(Config keywords,
    batches, flat weights)`` of ``configs`` (under --batchnorm the
    running statistics from their init). Per round: the
    whole aggregate (a 2-D rank's columns gathered), the weights, the
    metrics, the byte totals, the server's selection, this rank's block
    of state rows and the running statistics. PyTorch's native CPU
    convolutions, as the one-device tests run them
    (tests/test_torch_cv_round.py)."""
    out = []
    for kw, batches, flat in configs:
        cfg = Config(device="cpu", num_clients=num_clients, **kw)
        with torch.backends.mkldnn.flags(enabled=False):
            model, opt = _fed_model(kind, cfg, flat, spec,
                                    batches[0]["mask"].shape[1])
            rounds = []
            for b in batches:
                for g in opt.param_groups:
                    g["lr"] = lr
                met = model(dict(b))
                agg = model.pending_aggregated
                if pm.model_axis_size(model.mesh) > 1:
                    agg = wirex.gather_columns(agg, model.mesh.model)
                agg = _np(agg)
                opt.step()
                lo, block = _state_block(model)
                rounds.append({
                    "agg": agg, "ps": _np(model.ps_weights),
                    "loss": met[0], "down": met[-2], "up": met[-1],
                    "last_updated": model.last_updated.copy(),
                    "lo": lo, "rows": block,
                    "bn": (None if model.model_state is None else
                           {k: _np(v) for k, v in
                            model.model_state.items()})})
        out.append({"rank": model.rank, "rounds": rounds})
    return out


def trainer_runs(argvs):
    """``cv_train.main(argv)`` for each of ``argvs`` inside this launched
    rank (main runs the rank's share; it launches nothing): each run's
    last result row."""
    from commefficient_tpu_torch.train import cv_train
    return [cv_train.main(argv)[-1] for argv in argvs]


def chaos_rounds(cfg_kw, chaos_kw, num_clients, batches, ps0, lr=0.01):
    """Chained per-client rounds of ``linear_loss`` with the chaos
    harness's transmit hook (data/chaos.py) on this rank's mesh (or on
    one device, outside a launched group): per round the aggregate and
    the weights."""
    from commefficient_tpu_torch.core.rounds import (ClientStates,
                                                     build_client_round,
                                                     build_server_round)
    from commefficient_tpu_torch.core.server import ServerState
    from commefficient_tpu_torch.data.chaos import ChaosConfig, ChaosInjector
    cfg = Config(device="cpu", **cfg_kw)
    cfg.grad_size = ps0.size
    mesh = pm.build_mesh(cfg)
    hook = ChaosInjector(ChaosConfig(**chaos_kw),
                         num_clients).transmit_transform()
    cr = build_client_round(cfg, linear_loss, batches[0]["x"].shape[1],
                            transmit_transform=hook, mesh=mesh)
    sr = build_server_round(cfg, mesh=mesh)
    ps = torch.from_numpy(ps0)
    cs = ClientStates.init(cfg, num_clients, ps, "cpu", mesh)
    ss = ServerState.init(cfg, "cpu", pm.model_axis_size(mesh))
    aggs, weights = [], []
    for r, b in enumerate(batches):
        w = b["mask"].shape[0]
        part = pm.client_slice(w, mesh)
        batch = {k: torch.from_numpy(b[k][part]) for k in ("x", "y", "mask")}
        ids = torch.from_numpy(b["client_ids"][part].astype(np.int64))
        kw = ({} if mesh is None else
              dict(total=max(float(b["mask"].sum()), 1.0), global_w=w))
        res = cr(ps, batch, cs, ids, round_index=r, **kw)
        ps, ss, _, _, _ = sr(ps, ss, res.aggregated, lr)
        aggs.append(_np(res.aggregated))
        weights.append(_np(ps))
    return {"aggs": aggs, "weights": weights}


def _owned_rows(model):
    """(ids, {field: rows}) of the clients whose state this rank owns:
    under the host store its store's range (``shard_range``), under the
    device placement its block of the rows (the model peers alike)."""
    store = model.client_store
    if store is not None:
        lo, hi = store.owned
        ids = np.arange(lo, hi, dtype=np.int64)
        rows, _ = store.gather(ids)
        return ids, {k: np.array(v) for k, v in rows.items()}
    lo, block = _state_block(model)
    per = next((a.shape[0] for a in block.values()), 0)
    cnt = max(0, min(per, model.num_clients - lo))
    return (np.arange(lo, lo + cnt, dtype=np.int64),
            {k: v[:cnt] for k, v in block.items()})


def _snapshot(model, opt):
    """The whole state a checkpoint holds, as this rank sees it: the
    weights, the server state gathered whole, this rank's owned client
    rows and the accounting arrays."""
    from commefficient_tpu_torch.runtime.checkpoint import _whole_server
    ss = opt.server_state
    ids, rows = _owned_rows(model)
    return {"ps": _np(model.ps_weights),
            "ss": tuple(_np(_whole_server(t, model))
                        for t in (ss.Vvelocity, ss.Verror)),
            "ss_local_shape": tuple(ss.Vvelocity.shape),
            "ids": ids, "rows": rows,
            "last_updated": model.last_updated.copy(),
            "client_last_seen": model.client_last_seen.copy(),
            "round_index": model.round_index}


def _failed_save(path, model, opt, bad):
    """``save_checkpoint(path)`` on every rank, with rank ``bad``'s archive
    write raising ``OSError``: the exception each rank raised, as (type
    name, message), or None."""
    from commefficient_tpu_torch.runtime import checkpoint as ck
    orig = ck._atomic_savez

    def broken(p, **arrays):
        raise OSError(28, "No space left on device", p)

    if model.rank == bad:
        ck._atomic_savez = broken
    try:
        ck.save_checkpoint(path, model, opt)
    except (OSError, RuntimeError) as e:
        return (type(e).__name__, str(e))
    finally:
        ck._atomic_savez = orig
    return None


def store_runs(runs, spec, num_clients, lr):
    """Runs of the ResNet9 cell (``spec`` its channels) through
    ``FedModel``/``FedOptimizer`` on this rank's mesh (or one device,
    outside a launched group). Each run is ``(Config keywords, flat
    weights, ops)``, the ops in order: ``("round", batch)``,
    ``("save", path)`` (``save_checkpoint``), ``("load", path)``
    (``load_checkpoint`` into this run's model), ``("autosave", (path
    dir, keep))`` (a ``RoundAutosaver`` called after every later round)
    and ``("snap",)``. Returns per run the rounds' records (weights,
    metrics, bytes, the store's timings), the snapshots (``_snapshot``)
    and the rank."""
    from commefficient_tpu_torch.runtime.checkpoint import (
        RoundAutosaver, load_checkpoint, save_checkpoint)
    out = []
    for kw, flat, ops in runs:
        cfg = Config(**{"device": "cpu", "num_clients": num_clients,
                        "dataset_name": "Synthetic", **kw})
        with torch.backends.mkldnn.flags(enabled=False):
            model, opt = _fed_model("cv", cfg, flat, spec, 2)
            for g in opt.param_groups:
                g["lr"] = lr
            rounds, snaps, saver = [], [], None
            for op in ops:
                if op[0] == "round":
                    met = model(dict(op[1]))
                    opt.step()
                    rounds.append({"ps": _np(model.ps_weights),
                                   "loss": met[0], "down": met[-2],
                                   "up": met[-1]})
                    if saver is not None:
                        saver(0)
                elif op[0] == "save":
                    save_checkpoint(op[1], model, opt)
                elif op[0] == "load":
                    load_checkpoint(op[1], model, opt)
                elif op[0] == "save_fails_on":
                    # the save of ``path`` with rank ``bad``'s write
                    # failing: every rank's exception, as (type, text)
                    path, bad = op[1]
                    snaps.append(_failed_save(path, model, opt, bad))
                elif op[0] == "autosave":
                    d, keep = op[1]
                    saver = RoundAutosaver(
                        cfg.replace(checkpoint_path=d,
                                    checkpoint_every_rounds=1,
                                    checkpoint_keep=keep),
                        model, opt, None, None, None, "t")
                else:
                    snaps.append(_snapshot(model, opt))
            timings = [dict(t) for t in model.store_timings]
            owned = (None if model.client_store is None
                     else tuple(model.client_store.owned))
            model.finalize()
        out.append({"rank": model.rank, "rounds": rounds, "snaps": snaps,
                    "timings": timings, "store_owned": owned})
    return out


def dense2d_rounds(cfg_kw, batches, ps0, lr=0.01):
    """Chained rounds of ``linear_loss`` through ``build_client_round`` and
    the probed ``build_server_round`` on this rank's mesh (none: one
    device), the legacy server noise of step s drawn from the (seed + 1,
    s) stream as ``FedOptimizer`` draws it: per round the weights, this
    rank's momentum window and the server's probes. ``lr``: a float or a
    (d,) array of per-coordinate LRs."""
    from commefficient_tpu_torch.core.rounds import (build_client_round,
                                                     build_server_round)
    from commefficient_tpu_torch.core.server import ServerState
    from commefficient_tpu_torch.privacy.mechanism import (
        SERVER_NOISE_TAG, noise_generator)
    cfg = Config(device="cpu", **cfg_kw)
    mesh = pm.build_mesh(cfg)
    cr = build_client_round(cfg, linear_loss, batches[0]["x"].shape[1],
                            mesh=mesh)
    sr = build_server_round(cfg, probes=True, mesh=mesh)
    if not np.isscalar(lr):
        lr = torch.from_numpy(np.asarray(lr, np.float32))
    ps = torch.from_numpy(ps0)
    ss = ServerState.init(cfg, "cpu", pm.model_axis_size(mesh),
                          0 if mesh is None else mesh.model.index)
    out = {"rank": 0 if mesh is None else mesh.rank,
           "model": (0, 1) if mesh is None else (mesh.model.index,
                                                 mesh.model.size),
           "weights": [], "Vvelocity": [], "probes": []}
    for r, b in enumerate(batches):
        w = b["mask"].shape[0]
        part = pm.client_slice(w, mesh)
        batch = {k: torch.from_numpy(v[part]) for k, v in b.items()}
        kw = ({} if mesh is None else
              dict(total=max(float(b["mask"].sum()), 1.0), global_w=w))
        res = cr(ps, batch, **kw)
        gen = (noise_generator(cfg.seed + 1, r + 1, SERVER_NOISE_TAG, "cpu")
               if cfg.do_dp else None)
        ps, ss, _, _, _, probes = sr(ps, ss, res.aggregated, lr, None,
                                     None, gen)
        out["weights"].append(_np(ps))
        out["Vvelocity"].append(_np(ss.Vvelocity))
        out["probes"].append({k: float(v) for k, v in probes.items()})
    return out


def owned_rows_exchange(cases, world_kw):
    """``parallel/rows.py`` ``sum_owned_rows`` and ``all_slot_rows`` on
    this rank's mesh for each ``(rows, owners)`` of ``cases``: the rank
    contributes the rows ``owners`` gives it, zeros elsewhere; returns
    this rank's summed slots and the all-gathered slot rows."""
    from commefficient_tpu_torch.parallel import rows as rowx
    mesh = pm.build_mesh(Config(device="cpu", **world_kw))
    out = []
    for rows, owners in cases:
        t = torch.from_numpy(rows)
        mine = torch.from_numpy(np.asarray(owners) == mesh.rank)
        local = torch.where(mine.reshape(-1, 1), t, torch.zeros_like(t))
        sharded = pm.is_sharded(t.shape[0], mesh)
        got = rowx.sum_owned_rows(local, mesh, sharded)
        out.append((_np(got), _np(rowx.all_slot_rows(got, mesh, sharded))))
    return out


def lag(r, n):
    """The reference elastic test's arrival process: client i of round
    r's cohort arrives ``(i + r) % 3`` rounds late (a pure function of
    its arguments, so it replays across a restore)."""
    return (np.arange(n) + r) % 3


def weighted_linear_loss(p, batch):
    """The reference asynchronous fold test's linear loss: each client's
    masked mean of ``c·p``."""
    n = torch.clamp(torch.sum(batch["mask"], -1), min=1.0)
    return torch.sum((batch["c"] @ p) * batch["mask"], -1) / n, \
        (torch.zeros_like(n),)


def weighted_folds(cases):
    """The staleness-weighted fused round (``build_client_round(...,
    client_weights=True)``) on this rank's mesh for each ``(Config
    keywords, batch, staleness)`` of ``cases``: this rank's slice of the
    clients and of their staleness, the whole round's Σ cw·n as the
    runtime passes it; returns this rank's aggregate (its columns on a
    model axis)."""
    from commefficient_tpu_torch.core.rounds import build_client_round
    from commefficient_tpu_torch.runtime.fed_model import _round_total
    out = []
    for kw, batch, stale in cases:
        cfg = Config(device="cpu", **kw)
        mesh = pm.build_mesh(cfg)
        w = batch["mask"].shape[0]
        part = pm.client_slice(w, mesh)
        cr = build_client_round(cfg, weighted_linear_loss,
                                batch["mask"].shape[1], mesh=mesh,
                                client_weights=True)
        res = cr(torch.zeros(cfg.grad_size),
                 {k: torch.from_numpy(v[part]) for k, v in batch.items()},
                 staleness=torch.from_numpy(stale[part]),
                 total=_round_total(batch["mask"], stale, cfg), global_w=w)
        out.append(_np(res.aggregated))
    return out


def fed_runs(runs):
    """Runs of ``linear_loss`` through ``FedModel``/``FedOptimizer`` on
    this rank's mesh (or one device outside a launched group). Each run
    is ``(Config keywords, d, lr, ops)``, an asynchronous run taking the
    ``lag`` arrival process; the ops in order: ``("round", batch)``,
    ``("save", path)``, ``("load", path)`` and ``("snap",)``. Returns per
    run the weights after every round, the dispatched variant keys, the
    asynchronous round stats, the snapshots (weights and round index),
    the autopilot's record, the ε spent and the rank."""
    from commefficient_tpu_torch.runtime.checkpoint import (load_checkpoint,
                                                            save_checkpoint)
    from commefficient_tpu_torch.runtime.fed_model import (FedModel,
                                                           FedOptimizer)
    out = []
    for kw, d, lr, ops in runs:
        cfg = Config(**{"device": "cpu", **kw})
        b = next(op[1] for op in ops if op[0] == "round")
        model = FedModel(None, torch.zeros(d),
                         lambda p, batch, a: linear_loss(p, batch), cfg,
                         padded_batch_size=b["mask"].shape[1])
        if cfg.async_buffer_size:
            model.attach_arrival_process(lag)
        opt = FedOptimizer([{"lr": lr}], cfg, model=model)
        rec = {"weights": [], "keys": [], "snaps": []}
        for op in ops:
            if op[0] == "round":
                rec["keys"].append(model._variant_key)
                model(dict(op[1]))
                opt.step()
                rec["weights"].append(_np(model.ps_weights))
            elif op[0] == "save":
                save_checkpoint(op[1], model, opt)
            elif op[0] == "load":
                load_checkpoint(op[1], model, opt)
            else:
                rec["snaps"].append((_np(model.ps_weights),
                                     model.round_index))
        model.finalize()
        out.append(dict(rec, rank=model.rank,
                        async_stats=list(model.async_round_stats),
                        ap=model.autopilot_record(),
                        eps=model.privacy_epsilon()))
    return out


def manifest_shards(runs_dir, ledger):
    """``registry.write_manifest`` on this rank of the launched group,
    rank 0 alone: the manifest's ``ledger_shards`` (None elsewhere)."""
    import json as _json
    from commefficient_tpu_torch.telemetry import registry
    if pm.rank() != 0:
        return None
    cfg = Config(device="cpu", num_devices=2, ledger=ledger)
    with open(registry.write_manifest(runs_dir, args=cfg,
                                      ledger=ledger)) as f:
        return _json.load(f).get("ledger_shards")


# the job service tests' linear model (tests/test_torch_fedservice.py)
SERVICE_DIM, SERVICE_B = 48, 2


def service_builder(cfg, device):
    """A job service tenant's ``builder(cfg, device)`` that pickles and
    imports no JAX: ``linear_loss`` through ``FedModel`` at lr 0.25 on
    ``device`` (a spatial job's ranks build it in their processes)."""
    from commefficient_tpu_torch.runtime.fed_model import (FedModel,
                                                           FedOptimizer)
    model = FedModel(None, torch.zeros(SERVICE_DIM),
                     lambda p, b, a: linear_loss(p, b), cfg,
                     padded_batch_size=SERVICE_B)
    assert device is None or model.device == torch.device(device.type)
    return model, FedOptimizer([{"lr": 0.25}], cfg, model=model)


def broken_builder(cfg, device):
    """``service_builder`` whose rank 1 raises."""
    if pm.rank() == 1:
        raise RuntimeError("rank 1 cannot build")
    return service_builder(cfg, device)
