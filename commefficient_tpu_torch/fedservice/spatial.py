"""A spatial job of several cards: its ranks as worker processes the
job service drives across scheduler ticks.

The port's mesh is one process a card (parallel/mesh.py), so a job the
service places on a block of C·M > 1 cards (``mesh_demand=(C, M)``)
runs in C·M worker processes, spawned by the daemon, one a card of its
block, joined into a process group of their own (a file rendezvous in
a temporary directory; NCCL on the card, gloo on the CPU). Each rank
takes its block's card (``torch.cuda.set_device``), not its local
index, and builds the job with the spec's ``builder(cfg, device)``
from a Config whose ``--num_devices``/``--mesh`` name the block's
shape, so ``build_mesh`` finds the group. ``parallel/mesh.launch``
joins its ranks and returns; these live until the job finishes or
moves, answering the daemon's commands over a pipe each:

- ``round``: the batch the daemon's feeder made (the feeder stays in
  the daemon) through ``model(batch)`` and ``opt.step()`` on every
  rank, then the job's autosave where ``--checkpoint_every_rounds``
  asks for one;
- ``state``: rank 0's server weights on the host;
- ``save`` / ``load``: runtime/checkpoint.py on every rank (a mesh
  save or a restore from any world);
- ``arrivals``: ``FedModel.attach_arrival_process`` on every rank;
- ``apply``: ``fn(model, opt)`` on every rank, every rank's result (an
  inspection hook: ``fn`` must pickle);
- ``close``: ``finalize`` and the group torn down.

Rank 0's reply carries its ledger records since the last reply (the
daemon's live plane reads them, as it reads a one-card job's sink) and
whether its SLO engine is burning. An exception on any rank comes back
with its traceback as ``SpatialJobError`` and stops every rank of the
job; a reply that does not come within ``REPLY_TIMEOUT_S`` (a dead or
hung rank) does the same, so the daemon never waits forever.
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
import time
import traceback
from datetime import timedelta
from multiprocessing.connection import wait

import numpy as np
import torch

#: seconds the daemon waits for every rank's reply to one command (the
#: first round of a job on the card loads its kernels)
REPLY_TIMEOUT_S = 900.0


class SpatialJobError(RuntimeError):
    """A rank of a spatial job failed (its traceback in the message),
    died, or did not answer in time; every rank of the job is stopped."""


def spatial_cfg(cfg, demand):
    """``cfg`` for the (C, M) block: ``--num_devices C·M``, and ``--mesh
    CxM`` where the model axis is more than one (``Cx1`` is the 1-D
    mesh)."""
    c, m = (int(x) for x in demand)
    return dataclasses.replace(cfg, num_devices=c * m,
                               mesh=f"{c}x{m}" if m > 1 else "")


class _Capture:
    """A sink that keeps rank 0's records until the next reply."""

    def __init__(self):
        self.records = []

    def write(self, rec):
        self.records.append(rec)

    def close(self):
        pass


def _worker(rank, world, backend, rdv, device, threads, cfg, builder,
            autosave_tag, conn):
    """Rank ``rank`` of a spatial job: build, then answer commands until
    ``close`` (or the daemon goes away)."""
    import torch.distributed as dist
    quiet = None
    if rank > 0:
        quiet = open(os.devnull, "w")
        sys.stdout = quiet
    joined = False
    try:
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(threads)
        dist.init_process_group(
            backend, init_method=f"file://{rdv}", rank=rank,
            world_size=world, timeout=timedelta(seconds=REPLY_TIMEOUT_S))
        joined = True
        model, opt = builder(cfg, device)
        capture = None
        if rank == 0:
            capture = _Capture()
            model.telemetry.add_sink(capture)
        saver = _autosaver(cfg, model, opt, autosave_tag)
        _reply(conn, "ok", None, model, capture)
        while True:
            cmd, arg = conn.recv()
            if cmd == "round":
                model(arg)
                opt.step()
                if saver is not None:
                    saver(0)
                out = None
            elif cmd == "state":
                out = (model.ps_weights.detach().to("cpu").numpy().copy()
                       if rank == 0 else None)
            elif cmd == "save":
                from commefficient_tpu_torch.runtime.checkpoint import \
                    save_checkpoint
                save_checkpoint(arg, model, opt)
                out = None
            elif cmd == "load":
                from commefficient_tpu_torch.runtime.checkpoint import \
                    load_checkpoint
                load_checkpoint(arg, model, opt)
                saver = _autosaver(cfg, model, opt, autosave_tag)
                out = None
            elif cmd == "arrivals":
                model.attach_arrival_process(arg)
                out = None
            elif cmd == "apply":
                out = arg(model, opt)
            elif cmd == "close":
                out = (model.ps_weights.detach().to("cpu").numpy().copy()
                       if rank == 0 else None)
                model.finalize()
                _reply(conn, "ok", out, model, capture)
                dist.barrier()
                return
            else:
                raise ValueError(f"unknown spatial job command {cmd!r}")
            _reply(conn, "ok", out, model, capture)
    except (EOFError, KeyboardInterrupt):
        pass
    except BaseException:
        try:
            conn.send(("error", f"rank {rank}:\n{traceback.format_exc()}",
                       None, None))
        except OSError:
            pass
    finally:
        if joined:
            dist.destroy_process_group()
        if quiet is not None:
            sys.stdout = sys.__stdout__
            quiet.close()


def _autosaver(cfg, model, opt, tag):
    if int(getattr(cfg, "checkpoint_every_rounds", 0) or 0) <= 0:
        return None
    from commefficient_tpu_torch.runtime.checkpoint import RoundAutosaver
    os.makedirs(cfg.checkpoint_path, exist_ok=True)
    return RoundAutosaver(cfg, model, opt, None, None, None, tag=tag)


def _reply(conn, status, out, model, capture):
    records = None
    if capture is not None:
        records, capture.records = capture.records, []
    slo = getattr(model, "_slo", None)
    conn.send((status, out, records,
               bool(slo is not None and slo.burning)))


class SpatialJob:
    """The worker processes of one spatial job on the cards ``devices``
    (its carved block) at ``demand = (C, M)``. ``cfg`` is the job's
    Config with its block's shape (``spatial_cfg``); ``builder(cfg,
    device)`` must pickle (a module-level function). Construction
    returns once every rank has built the job. ``on_records(records)``
    receives rank 0's ledger records after each command."""

    def __init__(self, cfg, builder, devices, demand, autosave_tag="",
                 on_records=None):
        import torch.multiprocessing as mp
        self.demand = tuple(int(x) for x in demand)
        self.on_records = on_records
        self.slo_burning = False
        devices = list(devices)
        world = len(devices)
        cuda = devices[0].type == "cuda"
        backend = "nccl" if cuda else "gloo"
        self._tmp = tempfile.mkdtemp(prefix="cet_spatial_")
        rdv = os.path.join(self._tmp, "rdv")
        threads = max(1, torch.get_num_threads() // world)
        ctx = mp.get_context("spawn")
        self._procs, self._conns = [], []
        try:
            for r, dev in enumerate(devices):
                parent, child = ctx.Pipe()
                p = ctx.Process(
                    target=_worker,
                    args=(r, world, backend, rdv,
                          dev if cuda else torch.device("cpu"), threads,
                          cfg, builder, autosave_tag, child),
                    daemon=True)
                p.start()
                child.close()
                self._procs.append(p)
                self._conns.append(parent)
            self._collect("build")
        except BaseException:
            self.kill()
            raise

    def _collect(self, what):
        """Every rank's reply to the command ``what``: their outputs in
        rank order. The first error, death or time-out stops every rank
        and raises."""
        pending = dict(enumerate(self._conns))
        outs = {}
        deadline = time.monotonic() + REPLY_TIMEOUT_S
        while pending:
            left = deadline - time.monotonic()
            ready = wait(list(pending.values()), timeout=max(0.0, left))
            if not ready:
                self.kill()
                raise SpatialJobError(
                    f"spatial job {self.demand}: ranks "
                    f"{sorted(pending)} did not answer {what!r} within "
                    f"{REPLY_TIMEOUT_S:.0f} s")
            for conn in ready:
                r = self._conns.index(conn)
                try:
                    status, out, records, burning = conn.recv()
                except (EOFError, OSError):
                    self.kill()
                    raise SpatialJobError(
                        f"spatial job {self.demand}: rank {r} died "
                        f"during {what!r}") from None
                if status == "error":
                    self.kill()
                    raise SpatialJobError(
                        f"spatial job {self.demand} failed during "
                        f"{what!r} on {out}")
                del pending[r]
                outs[r] = out
                if r == 0:
                    self.slo_burning = burning
                    if records and self.on_records is not None:
                        self.on_records(records)
        return [outs[r] for r in range(len(outs))]

    def call(self, cmd, arg=None):
        """Send ``cmd`` to every rank; every rank's output, in rank
        order."""
        if not self._conns:
            raise SpatialJobError(f"spatial job {self.demand} is stopped")
        for conn in self._conns:
            try:
                conn.send((cmd, arg))
            except (OSError, ValueError):
                self.kill()
                raise SpatialJobError(
                    f"spatial job {self.demand}: a rank is gone") from None
        return self._collect(cmd)

    def round(self, batch):
        self.call("round", {k: np.asarray(v) for k, v in batch.items()})

    def state(self) -> np.ndarray:
        return self.call("state")[0]

    def save(self, path: str):
        self.call("save", path)

    def restore(self, path: str):
        self.call("load", path)

    def attach_arrival_process(self, fn):
        self.call("arrivals", fn)

    def apply(self, fn) -> list:
        """``fn(model, opt)`` on every rank; their results in rank
        order."""
        return self.call("apply", fn)

    def close(self) -> np.ndarray:
        """Finalize every rank, tear the group down and stop the
        processes; rank 0's final weights."""
        try:
            out = self.call("close")[0]
            for p in self._procs:
                p.join(timeout=REPLY_TIMEOUT_S)
            return out
        finally:
            self.kill()

    def kill(self):
        """Stop every rank now (idempotent)."""
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        shutil.rmtree(self._tmp, ignore_errors=True)
