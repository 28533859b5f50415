"""Full-state checkpoint and resume of the federated runtime.

Port of ``commefficient_tpu/runtime/checkpoint.py``:
``TornCheckpointError`` :54, ``checkpoint_file`` :62, ``_shard_file``
:66, ``_atomic_savez`` :71, ``_verify_archive`` :85,
``validate_checkpoint`` :109, ``current_topology`` :133,
``resume_manifest_extra`` :145, ``_prune_stale_shards`` :164,
``_merged_store_shard`` :181, ``save_checkpoint`` :218,
``load_checkpoint`` :450, ``history_file`` :762, ``RoundAutosaver``
:768-846, ``_resolve_resume_source`` :849 and ``setup_resume`` :878.

A checkpoint is one ``np.savez_compressed`` archive with a JSON
``meta`` entry, written atomically (tmp + rename), with the reference's
keys: ``ps_weights``; the per-client rows (``cs_velocities``,
``cs_errors``, ``cs_weights``: the device placement's (num_clients,
...) rows) or the host store's sparse shard (``store:ids``,
``store:<field>``, ``store:init:<field>``) and its issue stamps;
``ss_Vvelocity``, ``ss_Verror``; the byte accounting's
``last_updated`` and ``client_last_seen``; ``bnstats:<path>`` running
statistics; and in ``meta`` the counters, the scheduler step, the
privacy accountant's state and the sampler, dataset, global numpy and
dropout RNG states, plus the sampler's live epoch for a mid-epoch save.
``meta["topology"]`` describes this run's one device. Resuming gives
the uninterrupted run's weights bit for bit: every noise stream of the
port is seeded by (seed, round, tag), so restoring the round index
restores them.

Either placement restores into either: a device-placement archive
fills the host store with every client's row, a host-store archive is
densified over its init rows.

On a mesh (parallel/mesh.py) every rank calls ``save_checkpoint`` and
``load_checkpoint`` (the saves are collectives). The archive holds the
whole state: the device placement's client rows all-gathered over
``clients``, the 2-D sketch server's columns and the dense server's
windows gathered over ``model``. Rank 0 writes the main archive (and
drops side shards past the world, ``_prune_stale_shards``); every other
rank writes its host store's shard beside it as ``<path>.shard<rank>.npz``
(``_shard_file``), and ``meta["clientstore"]["processes"]`` is the
world. A barrier and a failure exchange follow, so an I/O error on any
rank fails every rank with its reason. A restore re-places the state
on the reading run's topology, values untouched: client rows re-padded
for its ``clients`` axis, server state re-sliced for its ``model`` axis,
and store shards imported one a rank where the world is the writer's,
else merged (``_merged_store_shard``) with each rank's store keeping
the rows it owns. ``RoundAutosaver`` links the side shards with each
history snapshot. The asynchronous driver's backlog (reference
:326-343, 698-725) rides as ``meta["asyncfed"]`` (fold, seq, totals,
pending, slot keys) and the ``async_arrive_at``, ``async_issue_seq``,
``async_issue`` and ``async:slot:<key>`` arrays; a resume rebuilds the
arrival heap, so the in-flight updates fold as in the uninterrupted
run. An archive with a backlog resumed without ``--async_buffer_size``
raises; an asynchronous run resumed from an archive without one warns
and starts with an empty buffer.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import tempfile
import warnings
import zipfile
from typing import Optional

import numpy as np
import torch

from commefficient_tpu_torch.core.rounds import (ClientStates,
                                                 resolve_rot_lanes)
from commefficient_tpu_torch.core.server import (ServerState, dense_window,
                                                 gather_window)
from commefficient_tpu_torch.parallel.mesh import (mesh_shape_dict,
                                                   model_axis_size,
                                                   topology_summary)
from commefficient_tpu_torch.parallel.wire import gather_columns

_FMT = 1
_FIELDS = ("velocities", "errors", "weights")


class TornCheckpointError(ValueError):
    """A checkpoint archive is missing, truncated or otherwise
    unreadable; the message names the file. ``setup_resume`` catches it
    and falls back to the newest retained autosave that validates."""


def checkpoint_file(directory: str, tag: str = "state") -> str:
    return os.path.join(directory, f"ckpt_{tag}.npz")


def _shard_file(path: str, process_index: int) -> str:
    """Side file of a non-zero process's client-store shard."""
    return f"{path}.shard{int(process_index)}.npz"


def _atomic_savez(path: str, **arrays):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def _verify_archive(path: str) -> None:
    """Refuse a torn or truncated .npz with an error naming the file
    (every member's CRC is checked)."""
    if not os.path.exists(path):
        raise TornCheckpointError(f"checkpoint shard missing: {path}")
    try:
        with zipfile.ZipFile(path) as zf:
            bad = zf.testzip()
        if bad is not None:
            raise TornCheckpointError(
                f"checkpoint shard {path} is torn: member {bad!r} "
                "fails its CRC")
    except TornCheckpointError:
        raise
    except (zipfile.BadZipFile, OSError, EOFError) as e:
        raise TornCheckpointError(
            f"checkpoint shard {path} is torn/truncated: {e}") from e


def validate_checkpoint(path: str) -> dict:
    """Verify the archive and every side shard its meta records; return
    the meta dict."""
    _verify_archive(path)
    try:
        with np.load(path, allow_pickle=False) as z:
            if "meta" not in z.files:
                raise TornCheckpointError(
                    f"checkpoint {path} has no meta entry — torn or "
                    "not a checkpoint archive")
            meta = json.loads(str(z["meta"]))
    except TornCheckpointError:
        raise
    except (ValueError, OSError, EOFError) as e:
        raise TornCheckpointError(
            f"checkpoint {path} is unreadable: {e}") from e
    procs = int((meta.get("clientstore") or {}).get("processes", 1))
    for k in range(1, procs):
        _verify_archive(_shard_file(path, k))
    return meta


def current_topology(model=None) -> dict:
    """This run's topology, stamped into the meta: its device count (the
    world), its host count (``parallel/mesh.py topology_summary``), the
    device type and, on a CUDA run, the card's name; on a mesh its
    shape."""
    dev = getattr(model, "device", None)
    dev = torch.device("cpu") if dev is None else torch.device(dev)
    mesh = getattr(model, "mesh", None)
    topo = {"device_count": 1, "process_count": 1,
            "platform": dev.type}
    if mesh is not None:
        hosts = topology_summary()
        topo.update(device_count=int(mesh.world.size),
                    process_count=int(hosts["process_count"]),
                    mesh_shape=mesh_shape_dict(mesh))
    if dev.type == "cuda":
        topo["device_kind"] = torch.cuda.get_device_name(dev)
    return topo


def resume_manifest_extra(model) -> dict:
    """``resumed_from`` (the checkpoint this run restored) and
    ``topology_segments`` (the restored chain plus the current
    segment); empty for a run that did not resume."""
    info = getattr(model, "_resume_info", None)
    if not info:
        return {}
    segments = list(getattr(model, "_restored_segments", []))
    segments.append({**current_topology(model),
                     "round_index": int(model.round_index)})
    return {"resumed_from": dict(info), "topology_segments": segments}


def _prune_stale_shards(path: str, processes: int) -> None:
    """Drop side shards whose index is at or past the writing world:
    a larger earlier topology left them, the meta just written does not
    record them, and a later resume on yet another world must not merge
    rows of the dead layout."""
    base = os.path.basename(path)
    pat = re.compile(re.escape(base) + r"\.shard(\d+)\.npz$")
    d = os.path.dirname(path) or "."
    for name in os.listdir(d):
        m = pat.fullmatch(name)
        if m and int(m.group(1)) >= int(processes):
            try:
                os.unlink(os.path.join(d, name))
            except OSError:
                pass


def _merged_store_shard(path: str, z, processes: int) -> dict:
    """Every writing rank's sparse store shard merged into one: rank 0's
    rows from the main archive ``z``, then each side file's. The ids are
    disjoint (contiguous ownership), so the merge is a concatenation;
    the init rows are the same everywhere and taken first seen.
    ``import_shard`` on the reading side keeps the rows each rank now
    owns."""
    shards = [{k[len("store:"):]: np.asarray(z[k])
               for k in z.files if k.startswith("store:")}]
    for k in range(1, int(processes)):
        sp = _shard_file(path, k)
        _verify_archive(sp)
        with np.load(sp, allow_pickle=False) as sz:
            shards.append({n: np.asarray(sz[n]) for n in sz.files})
    merged = {}
    for sh in shards:
        for n, v in sh.items():
            if n.startswith("init:") and n not in merged:
                merged[n] = v
    merged["ids"] = np.concatenate(
        [np.asarray(sh.get("ids", np.zeros((0,), np.int64)), np.int64)
         for sh in shards])
    fields = sorted({n for sh in shards for n in sh
                     if n != "ids" and not n.startswith("init:")})
    for f in fields:
        parts = []
        for i, sh in enumerate(shards):
            if f not in sh:
                raise TornCheckpointError(
                    f"clientstore shard {i} of {path} lacks field "
                    f"{f!r} — partial shard set")
            parts.append(np.asarray(sh[f]))
        merged[f] = np.concatenate(parts)
    return merged


def _host(t) -> np.ndarray:
    return t.detach().to("cpu").numpy()


def _world(model) -> tuple:
    """(this rank, the world) of the model's run: (0, 1) off a mesh."""
    mesh = getattr(model, "mesh", None)
    return (0, 1) if mesh is None else (mesh.rank, mesh.world.size)


def _whole_rows(val: torch.Tensor, model) -> torch.Tensor:
    """The device placement's (num_clients, ...) client rows: on a mesh
    the ranks' blocks all-gathered over ``clients`` (the model peers
    hold the same), the dead-slot rows and the padding left out."""
    nc = int(model.num_clients)
    mesh = getattr(model, "mesh", None)
    if mesh is None:
        return val[:nc]
    block = val[:-1]
    return mesh.clients.all_gather(block).reshape(
        (-1,) + tuple(block.shape[1:]))[:nc]


def _whole_server(t: torch.Tensor, model) -> torch.Tensor:
    """A server state buffer whole: on a model axis the sketch table's
    columns or the dense vector's windows gathered over ``model``."""
    mesh = getattr(model, "mesh", None)
    if model_axis_size(mesh) <= 1:
        return t
    if t.ndim == 2:
        return gather_columns(t, mesh.model)
    return gather_window(t, int(model.args.grad_size), mesh.model)


def _my_server(arr: np.ndarray, model) -> np.ndarray:
    """This rank's piece of a whole server state buffer: its columns of
    a sketch table or its window of the dense vector on a model axis."""
    mesh = getattr(model, "mesh", None)
    m = model_axis_size(mesh)
    if m <= 1:
        return arr
    if arr.ndim == 2:
        cl = arr.shape[1] // m
        return arr[:, mesh.model.index * cl:(mesh.model.index + 1) * cl]
    lo, hi = dense_window(arr.shape[0], m, mesh.model.index)
    return arr[lo:hi]


def _my_rows(base: np.ndarray, cur: torch.Tensor, model) -> torch.Tensor:
    """This rank's block of the whole (num_clients, ...) rows ``base``
    in the layout of ``cur`` (its block and its dead-slot row, which
    stays as this run made it), re-padded for this run's ``clients``
    axis."""
    per = cur.shape[0] - 1
    mesh = getattr(model, "mesh", None)
    lo = 0 if mesh is None else mesh.clients.index * per
    piece = np.asarray(base)[lo:lo + per]
    out = cur.clone()
    out[:per].zero_()
    if len(piece):
        out[:len(piece)] = torch.from_numpy(np.array(piece)).to(cur.device)
    return out


def _fail_together(err, model, path):
    """On a mesh, after every rank's part of a save: a barrier that also
    carries each rank's failure, so a write error on one rank fails
    every rank with its reason instead of leaving the others waiting
    (reference :425-445)."""
    _, world = _world(model)
    if world > 1:
        import torch.distributed as dist
        why = [None] * world
        dist.all_gather_object(
            why, None if err is None else f"{type(err).__name__}: {err}")
        bad = [(r, w) for r, w in enumerate(why) if w is not None]
        if bad and err is None:
            raise RuntimeError(
                f"checkpoint write failed on rank(s) "
                + "; ".join(f"{r} ({w})" for r, w in bad) + f" ({path})")
    if err is not None:
        raise err


def _bn_key(path) -> str:
    """A running statistic's archive key: ``bnstats:`` and the leaf
    path as jax's ``keystr`` writes it (``['a']['b']``)."""
    return "bnstats:" + "".join(f"[{seg!r}]" for seg in path)


def _rng_meta(state):
    return [state[0], None, int(state[2]), int(state[3]), float(state[4])]


def save_checkpoint(path: str, model, opt, scheduler=None,
                    sampler=None, epoch: int = 0,
                    extra: Optional[dict] = None,
                    loader=None, mid_epoch: bool = False) -> str:
    """Write the full runtime state to ``path`` (.npz). ``mid_epoch``
    (the round-cadence autosaver) also captures the sampler's live
    epoch, so a resumed run continues the interrupted epoch's remaining
    rounds; epoch-boundary saves must not set it."""
    if getattr(model, "_inflight", None):
        raise RuntimeError("checkpoint requested with pipelined rounds "
                           "inflight; drain with model.flush(force="
                           "True) (the trainers do this at epoch end)")
    rank, world = _world(model)
    store = getattr(model, "client_store", None)
    if store is not None:
        # land the round still awaiting write-back (on a mesh, every
        # rank: its exchange is a collective)
        model._store_writeback()
    nc = int(model.num_clients)
    arrays = {"ps_weights": _host(model.ps_weights)}
    cs = model.client_states
    for name in _FIELDS:
        val = getattr(cs, name)
        if val is not None:
            # the device rows without the dead-slot row (on a mesh every
            # rank's block, gathered by every rank)
            arrays["cs_" + name] = _host(_whole_rows(val, model))
    ss = opt.server_state
    arrays["ss_Vvelocity"] = _host(_whole_server(ss.Vvelocity, model))
    arrays["ss_Verror"] = _host(_whole_server(ss.Verror, model))
    arrays["last_updated"] = model.last_updated
    arrays["client_last_seen"] = model.client_last_seen
    if getattr(model, "model_state", None) is not None:
        for leaf_path, leaf in model.model_state.items():
            arrays[_bn_key(leaf_path)] = _host(leaf)
    topo = current_topology(model)
    meta = {
        "format": _FMT,
        "epoch": int(epoch),
        "round_index": int(model.round_index),
        "update_round": int(model._update_round),
        "fedavg_lr": float(model.fedavg_lr),
        "opt_step_count": int(opt._step_count),
        "mode": model.args.mode,
        "grad_size": int(model.args.grad_size),
        "num_clients": nc,
        "transmit_shape": list(model.args.transmit_shape),
        "error_type": model.args.error_type,
        "extra": extra or {},
        "topology": topo,
        "segments": (list(getattr(model, "_restored_segments", []))
                     + [{**topo, "round_index": int(model.round_index)}]),
    }
    if model.args.mode == "sketch":
        meta["rot_lanes"] = int(resolve_rot_lanes(model.args))
    err = None
    if store is not None:
        # the sparse shard: the rows clients wrote, and each field's
        # init row so never-seen clients keep the original run's init;
        # rank 0's in the main archive, every other rank's beside it
        meta["clientstore"] = {"fields": list(store.field_names),
                               "processes": world}
        shard = store.export_shard()
        if rank == 0:
            for k, v in shard.items():
                arrays["store:" + k] = v
        else:
            try:
                _atomic_savez(_shard_file(path, rank), **shard)
            except Exception as e:
                # reported to every rank after the barrier below
                err = e
        # the issue stamps are the same on every rank: rank 0's
        stamp_ids, stamp_rounds = store.export_stamps()
        if stamp_ids.size:
            arrays["store_stamp_ids"] = stamp_ids
            arrays["store_stamp_rounds"] = stamp_rounds
    drv = getattr(model, "_async_driver", None)
    if drv is not None:
        # the buffered-arrival backlog: without it a resumed run would
        # drop every update in flight
        st = drv.export_state()
        meta["asyncfed"] = {
            "fold": st["fold"], "seq": st["seq"],
            "issued_total": st["issued_total"],
            "folded_total": st["folded_total"],
            "pending": int(st["arrive_at"].shape[0]),
            "slot_keys": list(st["slot_keys"]),
        }
        arrays["async_arrive_at"] = st["arrive_at"]
        arrays["async_issue_seq"] = st["issue_seq"]
        arrays["async_issue"] = st["issue"]
        for k, v in st["slots"].items():
            arrays["async:slot:" + k] = v
    acc = getattr(model, "_accountant", None)
    if acc is not None:
        meta["privacy"] = acc.state_dict()
    if scheduler is not None:
        meta["scheduler_step"] = int(scheduler._step)
    if sampler is not None and hasattr(sampler.rng, "get_state"):
        state = sampler.rng.get_state()
        meta["sampler_rng"] = _rng_meta(state)
        arrays["sampler_rng_keys"] = np.asarray(state[1])
    # the PersonaChat dataset's personality shuffles advance its RNG on
    # every access
    ds_rng = getattr(getattr(sampler, "dataset", None), "_rng", None)
    if ds_rng is not None and hasattr(ds_rng, "getstate"):
        version, internal, gauss = ds_rng.getstate()
        meta["dataset_rng"] = [int(version), gauss]
        arrays["dataset_rng_state"] = np.asarray(internal, np.int64)
    # the CV transform stacks draw from the global numpy RNG
    g = np.random.get_state()
    meta["np_global_rng"] = _rng_meta(g)
    arrays["np_global_rng_keys"] = np.asarray(g[1])
    if loader is not None and hasattr(loader, "_round_counter"):
        meta["loader_round_counter"] = int(loader._round_counter)
    dr = getattr(loader, "_dropout_rng", None)
    if dr is not None and hasattr(dr, "get_state"):
        g = dr.get_state()
        meta["dropout_rng"] = _rng_meta(g)
        arrays["dropout_rng_keys"] = np.asarray(g[1])
    if mid_epoch and sampler is not None \
            and hasattr(sampler, "export_state"):
        st = sampler.export_state()
        if st is not None:
            meta["sampler_mid_epoch"] = True
            arrays["sampler_mid_permuted"] = np.asarray(st["permuted"])
            arrays["sampler_mid_cur"] = np.asarray(st["cur"])
            if st.get("rng_state") is not None:
                rs = st["rng_state"]
                meta["sampler_mid_rng"] = _rng_meta(rs)
                arrays["sampler_mid_rng_keys"] = np.asarray(rs[1])
            if st.get("spec_workers") is not None:
                arrays["sampler_mid_spec_workers"] = st["spec_workers"]
                arrays["sampler_mid_spec_sizes"] = st["spec_sizes"]
                arrays["sampler_mid_spec_idx"] = st["spec_idx"]
    if rank == 0:
        # one writer: concurrent writers on a shared file system would
        # corrupt the archive
        try:
            _atomic_savez(path, meta=json.dumps(meta), **arrays)
            _prune_stale_shards(path, world)
        except Exception as e:
            err = e
    _fail_together(err, model, path)
    return path


def load_checkpoint(path: str, model, opt, scheduler=None,
                    sampler=None, loader=None) -> dict:
    """Restore the runtime state in place; returns the meta dict
    (``meta["epoch"]`` is the epoch to resume)."""
    validate_checkpoint(path)
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        ck_store = meta.get("clientstore")
        ck_procs = int((ck_store or {}).get("processes", 1))
        rank, world = _world(model)
        checks = [("format", _FMT),
                  ("grad_size", int(model.args.grad_size)),
                  ("mode", model.args.mode),
                  ("num_clients", int(model.num_clients))]
        if "transmit_shape" in meta:
            checks.append(("transmit_shape",
                           list(model.args.transmit_shape)))
            checks.append(("error_type", model.args.error_type))
        if model.args.mode == "sketch":
            got = int(meta.get("rot_lanes", 0))
            want = int(resolve_rot_lanes(model.args))
            if got != want:
                raise ValueError(
                    f"checkpoint rot_lanes={got} does not match "
                    f"this run's {want} ({path})")
        for key, want in checks:
            if meta[key] != want:
                raise ValueError(
                    f"checkpoint {key}={meta[key]!r} does not match "
                    f"this run's {want!r} ({path})")
        # the set of per-client fields follows the config, whichever
        # placement wrote the archive
        ck_fields = set((ck_store or {}).get("fields", []))
        uses = {"velocities": model.args.local_momentum > 0,
                "errors": model.args.error_type == "local",
                "weights": bool(model.args.do_topk_down)}
        for field, used in uses.items():
            has = ("cs_" + field in z.files) or (field in ck_fields)
            if has != used:
                raise ValueError(
                    f"checkpoint {'has' if has else 'lacks'} "
                    f"client {field} but this run "
                    f"{'does not use' if not used else 'needs'} them "
                    "— momentum/error/topk_down flags differ")
        dev = model.device
        nc = int(model.num_clients)
        model.ps_weights = torch.from_numpy(
            np.array(z["ps_weights"])).to(dev)
        store = getattr(model, "client_store", None)
        if store is not None:
            if ck_store is not None:
                if ck_procs == world and rank == 0:
                    # the shard files line up with the ownership: each
                    # rank imports its own
                    shard = {k[len("store:"):]: np.asarray(z[k])
                             for k in z.files if k.startswith("store:")}
                elif ck_procs == world:
                    with np.load(_shard_file(path, rank),
                                 allow_pickle=False) as sz:
                        shard = {k: np.asarray(sz[k]) for k in sz.files}
                else:
                    # another world: every writer's rows, of which the
                    # import keeps the ones this rank owns now
                    shard = _merged_store_shard(path, z, ck_procs)
                store.import_shard(shard)
                if "store_stamp_ids" in z.files:
                    store.import_stamps(z["store_stamp_ids"],
                                        z["store_stamp_rounds"])
            else:
                # a device-placement archive: every client's row
                shard = {"ids": np.arange(nc, dtype=np.int64)}
                for field in store.field_names:
                    shard[field] = np.asarray(z["cs_" + field])[:nc]
                store.import_shard(shard)
            model.client_states = ClientStates(None, None, None)
        else:
            cs = model.client_states
            merged = (_merged_store_shard(path, z, ck_procs)
                      if ck_store is not None else None)

            def rows(field):
                cur = getattr(cs, field)
                if cur is None:
                    return None
                if merged is not None:
                    # a host-store archive (every writer's shard),
                    # densified over its init row
                    ids = np.asarray(merged["ids"], np.int64)
                    init = merged.get("init:" + field)
                    shape = (nc,) + tuple(cur.shape[1:])
                    base = (np.broadcast_to(np.asarray(init), shape).copy()
                            if init is not None
                            else np.zeros(shape, np.float32))
                    base[ids] = np.asarray(merged[field])
                else:
                    base = np.asarray(z["cs_" + field])[:nc]
                # this rank's block; the dead-slot row stays as this run
                # made it
                return _my_rows(base, cur, model)

            model.client_states = ClientStates(*(rows(f) for f in _FIELDS))
        opt.server_state = ServerState(*(
            torch.from_numpy(np.array(_my_server(np.asarray(z[k]), model)))
            .to(dev) for k in ("ss_Vvelocity", "ss_Verror")))
        model.last_updated = np.array(z["last_updated"])
        model.client_last_seen = np.array(z["client_last_seen"])
        if getattr(model, "model_state", None) is not None:
            if not any(k.startswith("bnstats:") for k in z.files):
                warnings.warn(
                    "checkpoint has no BN running stats; resuming with "
                    "freshly initialised statistics")
            else:
                restored = {}
                for leaf_path, leaf in model.model_state.items():
                    key = _bn_key(leaf_path)
                    if key not in z.files:
                        raise ValueError(
                            f"checkpoint lacks BN running stats {key} "
                            "but this run tracks them")
                    restored[leaf_path] = torch.from_numpy(
                        np.array(z[key])).to(leaf.device, leaf.dtype)
                model.model_state = restored
        model.round_index = meta["round_index"]
        model._update_round = meta["update_round"]
        model._rebuild_round_counts()
        model.fedavg_lr = meta["fedavg_lr"]
        opt._step_count = meta["opt_step_count"]
        if scheduler is not None and "scheduler_step" in meta:
            scheduler._step = meta["scheduler_step"]
        if sampler is not None and "sampler_rng" in meta:
            s = meta["sampler_rng"]
            sampler.rng.set_state((s[0], np.asarray(z["sampler_rng_keys"]),
                                   s[2], s[3], s[4]))
        ds_rng = getattr(getattr(sampler, "dataset", None), "_rng", None)
        if ds_rng is not None and "dataset_rng" in meta:
            version, gauss = meta["dataset_rng"]
            internal = tuple(int(v) for v in z["dataset_rng_state"])
            ds_rng.setstate((version, internal, gauss))
        if "np_global_rng" in meta:
            g = meta["np_global_rng"]
            np.random.set_state((g[0], np.asarray(z["np_global_rng_keys"]),
                                 g[2], g[3], g[4]))
        if loader is not None and "loader_round_counter" in meta \
                and hasattr(loader, "_round_counter"):
            loader._round_counter = meta["loader_round_counter"]
        dr = getattr(loader, "_dropout_rng", None)
        if dr is not None and "dropout_rng" in meta \
                and hasattr(dr, "set_state"):
            g = meta["dropout_rng"]
            dr.set_state((g[0], np.asarray(z["dropout_rng_keys"]),
                          g[2], g[3], g[4]))
        if sampler is not None and meta.get("sampler_mid_epoch") \
                and hasattr(sampler, "import_state"):
            st = {"permuted": np.asarray(z["sampler_mid_permuted"]),
                  "cur": np.asarray(z["sampler_mid_cur"])}
            if "sampler_mid_rng" in meta:
                r = meta["sampler_mid_rng"]
                st["rng_state"] = (r[0],
                                   np.asarray(z["sampler_mid_rng_keys"]),
                                   r[2], r[3], r[4])
            if "sampler_mid_spec_workers" in z.files:
                st["spec_workers"] = np.asarray(
                    z["sampler_mid_spec_workers"])
                st["spec_sizes"] = np.asarray(z["sampler_mid_spec_sizes"])
                st["spec_idx"] = np.asarray(z["sampler_mid_spec_idx"])
            sampler.import_state(st)
        # the asynchronous backlog: the arrival heap and counters
        drv = getattr(model, "_async_driver", None)
        ck_async = meta.get("asyncfed")
        if drv is not None and ck_async is not None:
            keys = list(ck_async.get("slot_keys", []))
            drv.import_state({
                "fold": ck_async["fold"], "seq": ck_async["seq"],
                "issued_total": ck_async["issued_total"],
                "folded_total": ck_async["folded_total"],
                "slot_keys": keys,
                "arrive_at": np.asarray(z["async_arrive_at"]),
                "issue_seq": np.asarray(z["async_issue_seq"]),
                "issue": np.asarray(z["async_issue"]),
                "slots": {k: np.asarray(z["async:slot:" + k])
                          for k in keys},
            })
        elif drv is not None:
            warnings.warn(
                "checkpoint has no asyncfed state (written by a "
                "synchronous run); the arrival buffer resumes empty")
        elif ck_async is not None and int(ck_async.get("pending", 0)):
            raise ValueError(
                f"checkpoint holds {ck_async['pending']} queued async "
                "arrival(s) but this run is synchronous; resume with "
                "--async_buffer_size or the buffered rounds in flight "
                f"are dropped ({path})")
        # the spent privacy budget: a DP resume from a DP-less archive
        # would reset the spent ε to zero, so it refuses
        ck_priv = meta.get("privacy")
        acc = getattr(model, "_accountant", None)
        if acc is not None and ck_priv is not None:
            model._accountant = type(acc).load_state(ck_priv)
        elif acc is not None:
            raise ValueError(
                "checkpoint has no privacy accountant state but this "
                "run is --dp sketch; resuming would reset the spent "
                f"ε budget to zero ({path})")
        elif ck_priv is not None:
            warnings.warn(
                "checkpoint carries a privacy accountant (written by "
                "a --dp sketch run) but this run has DP off; the "
                "spent-budget state is dropped")
        model._restored_segments = list(
            meta.get("segments")
            or ([meta["topology"]] if meta.get("topology") else []))
        model._resume_info = {
            "checkpoint": os.path.abspath(path),
            "epoch": int(meta.get("epoch", 0)),
            "round_index": int(meta.get("round_index", 0)),
            "topology": meta.get("topology"),
        }
    return meta


def history_file(directory: str, tag: str, round_index: int) -> str:
    """A retained autosave snapshot's path (round-stamped)."""
    return os.path.join(directory,
                        f"ckpt_{tag}_r{int(round_index):08d}.npz")


def _snapshots(directory: str, tag: str) -> list:
    """(round, file name) of the retained autosaves, oldest first."""
    pat = re.compile(rf"^ckpt_{re.escape(tag)}_r(\d+)\.npz$")
    return sorted((int(m.group(1)), m.group(0))
                  for m in (pat.match(n) for n in os.listdir(directory))
                  if m)


class RoundAutosaver:
    """``--checkpoint_every_rounds``: after every completed round, a
    mid-epoch checkpoint at the configured cadence (skipped while
    pipelined rounds are in flight; the next eligible round retries),
    then up to ``--checkpoint_keep`` round-stamped history snapshots,
    hard links to the archive just written (a copy where links fail),
    the oldest beyond the budget removed. The save is tmp + rename
    atomic, so a signal at any point leaves the previous or the new
    checkpoint whole."""

    def __init__(self, args, model, opt, scheduler, sampler, loader,
                 tag: str):
        self.every = int(args.checkpoint_every_rounds or 0)
        self.keep = int(args.checkpoint_keep or 0)
        self.args = args
        self.model, self.opt, self.scheduler = model, opt, scheduler
        self.sampler, self.loader, self.tag = sampler, loader, tag
        self.path = checkpoint_file(args.checkpoint_path, tag)
        self._last_saved = -1

    def __call__(self, epoch: int):
        """``epoch``: the 0-based epoch in progress (a mid-epoch resume
        re-enters it)."""
        if self.every <= 0:
            return
        r = int(self.model.round_index)
        if r <= 0 or r % self.every or r == self._last_saved:
            return
        if getattr(self.model, "_inflight", None):
            return
        save_checkpoint(self.path, self.model, self.opt, self.scheduler,
                        self.sampler, epoch=int(epoch), loader=self.loader,
                        mid_epoch=True)
        self._last_saved = r
        rank, _ = _world(self.model)
        if self.keep > 0 and rank == 0:
            self._retain(r)

    def _retain(self, round_index: int):
        """The snapshot of round ``round_index``: links to the archive
        and to every side shard of this run's world, so a fallback
        resume onto it finds the matching shard set; the oldest
        snapshots past ``--checkpoint_keep`` removed with theirs."""
        def link(src, dst):
            if os.path.exists(dst) or not os.path.exists(src):
                return
            try:
                os.link(src, dst)
            except OSError:
                shutil.copy2(src, dst)

        directory = self.args.checkpoint_path
        hist = history_file(directory, self.tag, round_index)
        link(self.path, hist)
        for k in range(1, _world(self.model)[1]):
            link(_shard_file(self.path, k), _shard_file(hist, k))
        for _, name in _snapshots(directory, self.tag)[:-self.keep]:
            doomed = [name] + [n for n in os.listdir(directory)
                               if n.startswith(name + ".shard")]
            for victim in doomed:
                try:
                    os.unlink(os.path.join(directory, victim))
                except OSError:
                    pass


def _resolve_resume_source(directory: str, path: str, tag: str) -> str:
    """The archive ``--resume`` restores: the canonical checkpoint when
    it validates, else the newest retained autosave that does; with
    none, the canonical's ``TornCheckpointError``."""
    try:
        validate_checkpoint(path)
        return path
    except TornCheckpointError as torn:
        for _, name in reversed(_snapshots(directory, tag)):
            hist = os.path.join(directory, name)
            try:
                validate_checkpoint(hist)
            except TornCheckpointError:
                continue
            print(f"WARNING: {torn} — falling back to retained "
                  f"autosave {hist}")
            return hist
        raise


def setup_resume(args, model, opt, scheduler, loader, tag: str):
    """The trainers' wiring: ``(start_epoch, epoch_hook, round_hook)``.
    ``--resume`` needs ``--checkpoint`` and an existing archive, else
    it raises; a torn canonical archive falls back to the newest
    retained autosave. ``epoch_hook(ep)`` saves every
    ``--checkpoint_every`` epochs and at the last; ``round_hook(epoch)``
    is the ``RoundAutosaver`` under ``--checkpoint_every_rounds``
    (None otherwise)."""
    if not (args.do_checkpoint or args.do_resume):
        return 0, None, None
    if args.do_resume and not args.do_checkpoint:
        raise ValueError("--resume requires --checkpoint")
    path = checkpoint_file(args.checkpoint_path, tag)
    sampler = getattr(loader, "sampler", None)
    start_epoch = 0
    if args.do_resume:
        if not os.path.exists(path):
            raise FileNotFoundError(f"--resume: no checkpoint at {path}")
        src = _resolve_resume_source(args.checkpoint_path, path, tag)
        meta = load_checkpoint(src, model, opt, scheduler, sampler,
                               loader)
        start_epoch = meta["epoch"]
        print(f"resumed from {src} at epoch {start_epoch}"
              + (" (mid-epoch)" if meta.get("sampler_mid_epoch") else ""))

    def epoch_hook(ep):
        if (args.checkpoint_every and ep % args.checkpoint_every == 0) \
                or ep >= math.ceil(args.num_epochs):
            save_checkpoint(path, model, opt, scheduler, sampler,
                            epoch=ep, loader=loader)

    round_hook = None
    if int(args.checkpoint_every_rounds or 0) > 0:
        round_hook = RoundAutosaver(args, model, opt, scheduler, sampler,
                                    loader, tag)
    return start_epoch, epoch_hook, round_hook
