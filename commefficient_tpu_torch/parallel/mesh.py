"""The multi-GPU round's process topology: one process per card.

Port of ``commefficient_tpu/parallel/mesh.py`` (``make_mesh`` :49,
``make_mesh2d`` :53, ``client_axis_size`` :98, ``model_axis_size`` :107,
``mesh_shape_dict`` :165, ``topology_summary`` :188, ``padded_rows``
:263, ``shard_batch`` :276 and its once-per-(W, n) warning :296) onto
``torch.distributed``: rank ``r`` owns ``cuda:r`` (NCCL) or, on the
CPU, one process (gloo). JAX's mesh axes become process groups:

- the 1-D ``clients`` mesh (``--num_devices N``): the world group; each
  rank runs its contiguous ``W/N`` clients of the round and the round
  all-reduces the table over the group once;
- the 2-D mesh (``--mesh CxM``): rank = c·M + m, as the reference's
  ``devices.reshape(C, M)``; the ``clients`` group of a rank is the C
  ranks with its model coordinate m, the ``model`` group the M ranks
  with its client coordinate c. A ``Cx1`` shape is the 1-D mesh;
- the sequence-parallel mesh (``--seq_devices N``, reference
  core/rounds_sp.py ``make_sp_mesh`` :56-64): rank = c·N + s; the
  ``clients`` group of a rank is the world/N ranks with its sequence
  coordinate s, the ``seq`` group the N ranks with its client
  coordinate c, over which each client's sequences are sharded.

An ``Axis`` is one axis as this rank sees it: its group, this rank's
index along it and its size, with the few collectives the round calls
and the ring shift of ring attention (``ring_shift``: one
``batch_isend_irecv`` to the next index and from the previous one).
An axis of size 1 made by ``make_mesh2d`` has no group and its
collectives are the identity; the 1-D mesh's ``clients`` axis is the
world group at any size, so a one-rank mesh still crosses NCCL.

``launch(world, fn, *args)`` starts ``world`` ranks (start method
spawn), each joining the group through a file rendezvous in a temporary
directory (so parallel test workers never share a port), runs
``fn(*args)`` in each and returns their results in rank order. The
backend is NCCL on the card and gloo on the CPU, never the other way
round: a CUDA run never takes gloo.

Several hosts (``--coordinator_address --num_processes P --process_id
i``; reference ``initialize_multihost`` :207 and
``maybe_initialize_multihost_cli`` :242): each host runs the trainer's
``main``, whose launcher starts one rank a visible card (L of them; one
on the CPU) as global ranks ``i·L`` to ``i·L + L - 1`` of a world of
``P·L``; each rank takes its card by its local index. Host 0's launcher
serves the rendezvous (a ``torch.distributed.TCPStore``) at the
coordinator address, every launcher publishes its L there and a
mismatch raises in each, naming both counts; the ranks join the group
through the same store. The rank order c·M + m is unchanged, so where M
divides L a ``model`` group (which carries the 2-D server's table and
window all-gathers) lies inside one host and only the ``clients``
crossings leave it. ``topology_summary`` counts hosts as the
reference counts processes: ``process_index`` this host's, its
``local_device_count`` the host's L ranks.
"""

from __future__ import annotations

import os
import pickle
import shutil
import sys
import tempfile
import warnings
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

CLIENT_AXIS = "clients"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"

# the tensor forms of all-gather and reduce-scatter under their newer
# names where this torch has them
_all_gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
_reduce_scatter = getattr(dist, "reduce_scatter_single",
                          dist.reduce_scatter_tensor)


class Axis:
    """One mesh axis from this rank: ``group`` (None where the axis has
    size 1 and no collective is needed), ``index`` along it, ``size``,
    and ``ranks``, the group's global ranks in axis order (the peers of
    ``ring_shift``)."""

    def __init__(self, group, index: int, size: int, ranks=None):
        self.group, self.index, self.size = group, int(index), int(size)
        self.ranks = (list(range(self.size)) if ranks is None
                      else [int(r) for r in ranks])

    def _live(self) -> bool:
        return self.group is not None

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis, in place (and returned)."""
        if self._live():
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def pmax(self, t: torch.Tensor) -> torch.Tensor:
        """Elementwise max over the axis, in place (and returned)."""
        if self._live():
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(size, *t.shape): every rank's ``t`` in axis order."""
        t = t.contiguous()
        if not self._live():
            return t.unsqueeze(0)
        # flat buffers: gloo takes the gathered dim 0 only as one axis
        out = t.new_empty(self.size * t.numel())
        _all_gather(out, t.reshape(-1), group=self.group)
        return out.reshape((self.size,) + tuple(t.shape))

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis of (size, ...) blocks, this rank keeping
        block ``index``."""
        t = t.contiguous()
        if not self._live():
            return t[0]
        out = t.new_empty(t[0].numel())
        _reduce_scatter(out, t.reshape(-1), op=dist.ReduceOp.SUM,
                        group=self.group)
        return out.reshape(tuple(t.shape[1:]))

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """(size, ...) blocks: block j goes to rank j; returns the
        (size, ...) blocks this rank received, in axis order."""
        t = t.contiguous()
        if not self._live():
            return t
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def ring_shift(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` sent to index + 1; returns what index - 1 sent (mod
        size). Both transfers go in one ``batch_isend_irecv``: a blocking
        send and receive around a ring deadlock, and on NCCL every rank
        of the group must join the group's first point-to-point call."""
        t = t.contiguous()
        if not self._live() or self.size == 1:
            return t
        out = torch.empty_like(t)
        nxt = self.ranks[(self.index + 1) % self.size]
        prv = self.ranks[(self.index - 1) % self.size]
        ops = [dist.P2POp(dist.isend, t, nxt, self.group),
               dist.P2POp(dist.irecv, out, prv, self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


class Mesh:
    """This rank's view of the C x M mesh: ``clients``, ``model`` and
    ``world`` axes, and its card (or the CPU); on the sequence-parallel
    mesh (``make_sp_mesh``) a ``seq`` axis of ``n_seq`` ranks in place
    of ``model``."""

    def __init__(self, n_clients: int, n_model: int, clients: Axis,
                 model: Axis, world: Axis, device: torch.device,
                 backend: str, seq: Optional[Axis] = None):
        self.n_clients, self.n_model = int(n_clients), int(n_model)
        self.clients, self.model, self.world = clients, model, world
        self.device, self.backend = device, backend
        self.seq = Axis(None, 0, 1) if seq is None else seq
        self.n_seq = self.seq.size

    @property
    def rank(self) -> int:
        return self.world.index

    @property
    def shape(self) -> dict:
        shape = {CLIENT_AXIS: self.n_clients}
        if self.n_model > 1:
            shape[MODEL_AXIS] = self.n_model
        if self.n_seq > 1:
            shape[SEQ_AXIS] = self.n_seq
        return shape

    def __repr__(self):
        inner = self.n_seq if self.n_seq > 1 else self.n_model
        return (f"Mesh({self.n_clients}x{inner}, rank {self.rank}, "
                f"{self.backend}, {self.device})")


def _world_axis() -> Axis:
    return Axis(dist.group.WORLD, dist.get_rank(), dist.get_world_size(),
                range(dist.get_world_size()))


def _device_of_rank(device_type: str) -> torch.device:
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(device_type: str = "cuda") -> Mesh:
    """The 1-D ``clients`` mesh over every rank of the launched group."""
    world = _world_axis()
    return Mesh(world.size, 1, world, Axis(None, 0, 1), world,
                _device_of_rank(device_type), dist.get_backend())


def make_mesh2d(n_clients: int, n_model: int,
                device_type: str = "cuda") -> Mesh:
    """The ``clients`` x ``model`` mesh of the launched group, whose
    size must be C·M; ``Cx1`` is ``make_mesh``. Every rank makes every
    group, in one order, as ``torch.distributed.new_group`` asks."""
    world = _world_axis()
    if n_clients * n_model != world.size:
        raise ValueError(f"mesh {n_clients}x{n_model} needs "
                         f"{n_clients * n_model} ranks, the group has "
                         f"{world.size}")
    if n_model == 1:
        return make_mesh(device_type)
    clients, model = _grid_axes(n_clients, n_model, world.index)
    return Mesh(n_clients, n_model, clients, model, world,
                _device_of_rank(device_type), dist.get_backend())


def _grid_axes(n_outer: int, n_inner: int, rank: int) -> tuple:
    """The two axes of rank ``rank`` = o·n_inner + i on an n_outer x
    n_inner grid: (outer axis, inner axis). An outer axis of size 1 has
    no group; every rank makes every other group, in one order."""
    oi, ii = divmod(rank, n_inner)
    outer = Axis(None, oi, 1)
    inner = None
    if n_outer > 1:
        for i in range(n_inner):
            ranks = [o * n_inner + i for o in range(n_outer)]
            g = dist.new_group(ranks)
            if i == ii:
                outer = Axis(g, oi, n_outer, ranks)
    for o in range(n_outer):
        ranks = [o * n_inner + i for i in range(n_inner)]
        g = dist.new_group(ranks)
        if o == oi:
            inner = Axis(g, ii, n_inner, ranks)
    return outer, inner


def make_sp_mesh(n_clients: int, n_seq: int,
                 device_type: str = "cuda") -> Mesh:
    """The ``clients`` x ``seq`` mesh of the launched group (reference
    core/rounds_sp.py ``make_sp_mesh``), whose size must be C·N: rank
    c·N + s, as the reference's ``devices.reshape(C, N)``. The ``seq``
    axis always has its group (a one-rank ring is the identity); the
    ``model`` axis has size 1."""
    world = _world_axis()
    if n_clients * n_seq != world.size:
        raise ValueError(f"sequence-parallel mesh {n_clients}x{n_seq} "
                         f"needs {n_clients * n_seq} ranks, the group has "
                         f"{world.size}")
    clients, seq = _grid_axes(n_clients, n_seq, world.index)
    return Mesh(n_clients, 1, clients, Axis(None, 0, 1), world,
                _device_of_rank(device_type), dist.get_backend(), seq=seq)


def client_axis_size(mesh: Optional[Mesh]) -> int:
    """Ranks along ``clients``: the divisor of the round's clients."""
    return 1 if mesh is None else mesh.n_clients


def model_axis_size(mesh: Optional[Mesh]) -> int:
    """Ranks along ``model`` (1 for the 1-D mesh or none): the server
    state's shard count. Every 2-D path gates on it being > 1."""
    return 1 if mesh is None else mesh.n_model


def mesh_shape_dict(mesh: Optional[Mesh]) -> dict:
    """``{axis: size}`` for manifests and the ledger's meta record; the
    one-card run is ``{"clients": 1}``."""
    return {CLIENT_AXIS: 1} if mesh is None else dict(mesh.shape)


def padded_rows(num_clients: int, mesh: Optional[Mesh]) -> int:
    """Rows of client-axis-sharded state: ``num_clients`` rounded up to
    the ``clients`` axis (reference :263). Rank c of the axis owns the
    contiguous block of ``padded_rows / C`` rows from ``c·padded_rows/C``
    (``core/rounds.py ClientStates.init``, parallel/rows.py); padded
    rows are never indexed."""
    n = client_axis_size(mesh)
    return -(-num_clients // n) * n


# this rank's host: (host index, host count, ranks on the host), set by
# ``_rank_entry``; a process outside a launch is host 0 of 1
_HOST = (0, 1, None)


def topology_summary() -> dict:
    """The run's topology as manifests and ledger meta records give it:
    {device_count, local_device_count, process_index, process_count,
    backend, device_kind}. A process is a host, as in the reference:
    ``process_index``/``process_count`` are this host's index and the
    host count, ``local_device_count`` the ranks this host launched
    (outside a launch, the visible cards), ``device_count`` the
    world."""
    on = launched()
    cuda = torch.cuda.is_available()
    host, hosts, local = _HOST
    if local is None:
        local = torch.cuda.device_count() if cuda else 1
    return {
        "device_count": dist.get_world_size() if on else 1,
        "local_device_count": local,
        "process_index": host,
        "process_count": hosts,
        "backend": dist.get_backend() if on else (
            "cuda" if cuda else "cpu"),
        "device_kind": torch.cuda.get_device_name() if cuda else "cpu",
    }


def client_slice(w: int, mesh: Optional[Mesh]) -> slice:
    """This rank's contiguous slice of a round's ``w`` clients: ``w/C``
    of them where the ``clients`` axis divides w, else all w (every
    rank computes every client, with the reference's once-per-(w, C)
    warning: correct, not load-balanced)."""
    n = client_axis_size(mesh)
    if n == 1:
        return slice(0, w)
    if w % n:
        _warn_unsharded(w, n)
        return slice(0, w)
    per = w // n
    return slice(mesh.clients.index * per, (mesh.clients.index + 1) * per)


def is_sharded(w: int, mesh: Optional[Mesh]) -> bool:
    """Whether a mesh round of ``w`` clients runs sharded, each rank
    its ``client_slice`` and the table crossing the mesh: on any mesh
    (one rank too, whose crossing is the identity) where the
    ``clients`` axis divides w. Otherwise every rank holds all w
    clients and no table crosses."""
    return mesh is not None and w % client_axis_size(mesh) == 0


_WARNED_UNSHARDED = set()


def _warn_unsharded(w: int, n: int):
    if (w, n) in _WARNED_UNSHARDED:
        return
    _WARNED_UNSHARDED.add((w, n))
    warnings.warn(
        f"batch leading dim {w} does not divide the {n}-device mesh: "
        f"replicating instead of sharding the client axis -- every "
        f"device computes all {w} clients. Pick --num_workers "
        f"divisible by the device count for full throughput.",
        RuntimeWarning, stacklevel=3)


# --- the ranks ---------------------------------------------------------

def hosts_of(cfg) -> Optional[tuple]:
    """``(coordinator_address, num_processes, process_id)`` of a run
    over several hosts, None for one host. The flags as the reference
    takes them (parallel/mesh.py:242-262): ``--process_id`` or
    ``--coordinator_address`` without ``--num_processes`` raises
    instead of running alone, as does a host index out of range or a
    multi-host run without an address; ``--num_processes 1`` is one
    host."""
    n = cfg.num_processes
    if n is None:
        if cfg.process_id is not None or cfg.coordinator_address:
            raise ValueError(
                "--process_id/--coordinator_address need --num_processes "
                "(the host count); a host does not run alone")
        return None
    n = int(n)
    if n < 1:
        raise ValueError(f"--num_processes {n} must be >= 1")
    pid = 0 if cfg.process_id is None else int(cfg.process_id)
    if not 0 <= pid < n:
        raise ValueError(f"--process_id {pid} is outside the {n} hosts")
    if n == 1:
        return None
    if cfg.process_id is None or not cfg.coordinator_address:
        raise ValueError(f"--num_processes {n} needs --process_id and "
                         "--coordinator_address host:port on every host")
    if int(cfg.num_devices) > 0:
        raise ValueError(
            "--num_devices is a single-host knob; on several hosts the "
            "mesh spans every host's cards (leave it at -1)")
    return (cfg.coordinator_address, n, pid)


def local_ranks(cfg) -> int:
    """The ranks one host of a multi-host run launches: one a visible
    card, one on the CPU; inside a launched rank, the count its
    launcher started."""
    if _HOST[2] is not None:
        return _HOST[2]
    if torch.device(cfg.device).type == "cpu":
        return 1
    return torch.cuda.device_count()


def resolve_world(cfg) -> int:
    """Ranks a run asks for: over several hosts (``hosts_of``) the
    hosts times this host's ``local_ranks``, which ``--mesh CxM`` must
    equal; else C·M under ``--mesh CxM``, else ``--num_devices`` (<= 0:
    every visible card, as the reference reads it; on the CPU, one).
    More than the visible cards raises."""
    hosts = hosts_of(cfg)
    if hosts is not None:
        n = hosts[1] * local_ranks(cfg)
        shape = cfg.mesh2d
        if shape is not None and shape[0] * shape[1] != n:
            raise ValueError(f"--mesh {cfg.mesh} needs {shape[0] * shape[1]}"
                             f" devices, {hosts[1]} hosts of "
                             f"{local_ranks(cfg)} give {n}")
        return n
    cpu = torch.device(cfg.device).type == "cpu"
    visible = None if cpu else torch.cuda.device_count()
    n = int(cfg.num_devices)
    if n <= 0:
        n = 1 if cpu else visible
    shape = cfg.mesh2d
    if shape is not None:
        need = shape[0] * shape[1]
        if need > n and int(cfg.num_devices) > 0:
            raise ValueError(f"--mesh {cfg.mesh} needs {need} devices, "
                             f"--num_devices gives {n}")
        n = need
    if visible is not None and n > visible:
        raise ValueError(f"{n} devices requested, {visible} visible")
    return max(1, n)


def build_mesh(cfg) -> Optional[Mesh]:
    """The run's mesh from the launched group, or None for a one-device
    run outside one. Asking for more than one device outside a
    launched group raises: the trainers' ``main`` launches the ranks."""
    world = resolve_world(cfg)
    if not launched():
        if world > 1:
            raise RuntimeError(
                f"{world} devices asked for (--num_devices/--mesh) but "
                "no process group is launched: start the run through "
                "the trainer's main(), which launches one rank a "
                "device (parallel/mesh.py launch)")
        return None
    if dist.get_world_size() != world:
        raise RuntimeError(f"the launched group has "
                           f"{dist.get_world_size()} ranks, the run asks "
                           f"for {world} devices")
    dev_type = torch.device(cfg.device).type
    if (dev_type == "cuda") != (dist.get_backend() == "nccl"):
        raise RuntimeError(f"a {dev_type} run on a "
                           f"{dist.get_backend()} group")
    shape = cfg.mesh2d
    if shape is not None:
        return make_mesh2d(shape[0], shape[1], dev_type)
    return make_mesh(dev_type)


def needs_launch(cfg) -> bool:
    """Whether a trainer's ``main`` must start the ranks: no group is
    launched yet, and the run asks for more than one device or spans
    several hosts."""
    if launched():
        return False
    return resolve_world(cfg) > 1 or hosts_of(cfg) is not None


def launch_run(cfg, fn, *args) -> list:
    """``launch`` as a trainer's ``main`` calls it for ``cfg``: its
    world, its device type, its hosts. Returns this launcher's ranks'
    results."""
    return launch(resolve_world(cfg), fn, *args,
                  device_type=torch.device(cfg.device).type,
                  hosts=hosts_of(cfg))


def launched() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if launched() else 0


def _rank_entry(r, world, backend, rdv, out_dir, threads, host, fn,
                args):
    """Local rank ``r`` of this host: global rank ``host[0]·L + r``.
    ``rdv``: the file rendezvous of a one-host launch, or the
    multi-host store's (address, port, timeout seconds)."""
    global _HOST
    g = host[0] * host[2] + r
    _HOST = host
    if backend == "nccl":
        torch.cuda.set_device(r)
    else:
        torch.set_num_threads(threads)
    if isinstance(rdv, str):
        dist.init_process_group(backend, init_method=f"file://{rdv}",
                                rank=g, world_size=world)
    else:
        addr, port, secs = rdv
        store = dist.TCPStore(addr, port, is_master=False,
                              timeout=timedelta(seconds=secs))
        dist.init_process_group(backend,
                                store=dist.PrefixStore("cet_group", store),
                                rank=g, world_size=world)
    quiet = None
    if g > 0:
        # global rank 0 alone prints; the others keep their errors
        quiet = open(os.devnull, "w")
        sys.stdout = quiet
    try:
        res = fn(*args)
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "wb") as f:
            pickle.dump(res, f)
        # every rank done before any tears the group down (a rank that
        # raised is stopped by the launcher instead)
        dist.barrier()
    finally:
        dist.destroy_process_group()
        if quiet is not None:
            sys.stdout = sys.__stdout__
            quiet.close()


# the multi-host rendezvous's wait for every host to connect (seconds)
RENDEZVOUS_S = 300


def _split_address(address: str) -> tuple:
    host, _, port = str(address).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"--coordinator_address {address!r} is not "
                         "host:port")
    return host.strip("[]"), int(port)


def host_rendezvous(address: str, hosts: int, host: int, local: int,
                    timeout_s: float = RENDEZVOUS_S):
    """The launchers' rendezvous of a multi-host run: host 0 serves the
    store at ``address``; every host publishes its ``local`` rank count
    and reads every other's. Returns the store (host 0 must keep it
    open while any rank runs). Unequal counts raise ``ValueError`` in
    every launcher, naming both."""
    addr, port = _split_address(address)
    store = dist.TCPStore(addr, port, None, host == 0,
                          timedelta(seconds=timeout_s),
                          wait_for_workers=False)
    store.set(f"cet_hosts/{host}", str(int(local)))
    for q in range(hosts):
        if q == host:
            continue
        other = int(store.get(f"cet_hosts/{q}"))
        if other != int(local):
            raise ValueError(
                f"host {q} launches {other} ranks and host {host} "
                f"launches {local}: every host needs the same count of "
                "visible cards")
    return store


def launch(world: int, fn, *args, device_type: str = "cuda",
           env: Optional[dict] = None, hosts: Optional[tuple] = None
           ) -> list:
    """Run ``fn(*args)`` in ``world`` ranks (spawned; ``fn`` and
    ``args`` must pickle) joined into one group, NCCL on the card and
    gloo on the CPU; returns this launcher's ranks' results in rank
    order. ``env``: the ranks' extra environment (``NCCL_*`` settings),
    each printed. ``hosts``: ``(coordinator_address, P, i)`` of a
    multi-host run (``hosts_of``), where this launcher starts its
    ``world / P`` ranks after the rendezvous (``host_rendezvous``) and
    host 0 serves the store until every host's ranks are done. Any
    rank's exception is raised here, with its traceback."""
    import torch.multiprocessing as mp
    backend = "nccl" if device_type == "cuda" else "gloo"
    n_hosts, host = (1, 0) if hosts is None else (hosts[1], hosts[2])
    if world % n_hosts:
        raise ValueError(f"{world} ranks do not split over {n_hosts} hosts")
    local = world // n_hosts
    if backend == "nccl" and local > torch.cuda.device_count():
        raise ValueError(f"{local} ranks need {local} cards, "
                         f"{torch.cuda.device_count()} visible")
    store = None
    if hosts is not None:
        store = host_rendezvous(hosts[0], n_hosts, host, local)
        print(f"multihost: process {host}/{n_hosts}, {world} devices",
              flush=True)
    for k in sorted(os.environ):
        if k.startswith("NCCL_"):
            print(f"mesh: inherited {k}={os.environ[k]}")
    saved = {}
    for k, v in (env or {}).items():
        print(f"mesh: launcher sets {k}={v}")
        saved[k] = os.environ.get(k)
        os.environ[k] = str(v)
    tmp = tempfile.mkdtemp(prefix="cet_mesh_")
    threads = max(1, torch.get_num_threads() // local)
    rdv = (os.path.join(tmp, "rdv") if hosts is None else
           _split_address(hosts[0]) + (RENDEZVOUS_S,))
    try:
        try:
            mp.start_processes(
                _rank_entry, args=(world, backend, rdv, tmp, threads,
                                   (host, n_hosts, local), fn, args),
                nprocs=local, join=True, start_method="spawn")
        finally:
            if store is not None:
                # host 0's store outlives every host's ranks
                store.set(f"cet_done/{host}", "1")
        if store is not None and host == 0:
            store.wait([f"cet_done/{q}" for q in range(n_hosts)],
                       timedelta(seconds=RENDEZVOUS_S))
        out = []
        for r in range(local):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
