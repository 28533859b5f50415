"""Per-client state rows sharded over the mesh's ``clients`` axis: who
owns a row, and the exchange that moves rows between their owners and
the ranks that run their clients.

The port of what XLA's partitioned gather and scatter do for the
reference's client-sharded ``ClientStates`` (``client_sharding`` and
``padded_rows``, commefficient_tpu/parallel/mesh.py:263-280; the row
reads ``client_states.velocities[client_ids]``, core/rounds.py:798-803,
and ``_scatter``, :1194-1197). Rank c of the ``clients`` axis owns the
contiguous block ``[c·per, (c+1)·per)`` of the padded rows
(``per = padded_rows(num_clients, C) / C``), held as a ``(per + 1, ...)``
tensor whose last row is the rank's own dead-slot row. On a 2-D mesh the
rows are replicated over ``model``: the model peers of a rank hold the
same block and run the same clients.

Rows move and are never summed: the gather is one ``all_to_all`` (or,
where every rank runs all W clients, one all-gather) of owned rows, the
scatter one all-gather of the new rows, each owner keeping its own. A
zero-padded all-reduce would turn a ``-0.0`` into ``+0.0``; a selection
keeps the owners' bits. A dead slot (id ``DEAD``) is routed to no
owner: its gather reads the local dead row, its scatter writes nowhere.

The host store on a mesh (``sum_owned_rows``, ``all_slot_rows``) keeps
the rows in each rank's ``HostClientStore``, which owns
``shard_range(num_clients, rank, world)`` of the ids: the round's rows
are summed from their owners' gathers and gathered back for their
owners' write-backs.
"""

from __future__ import annotations

import torch

# a dead slot's id in the exchange: owned by no rank
DEAD = -1


def exchange_ids(ids: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """(W,) state ids with each dead slot at ``DEAD``."""
    ids = ids.to(torch.int64)
    return torch.where(alive, ids, torch.full_like(ids, DEAD))


def local_ids(ids: torch.Tensor, per: int, axis) -> torch.Tensor:
    """(n,) exchange ids -> this rank's local rows: an owned id at its
    row of the block, every other id (another rank's, or ``DEAD``) at
    the local dead row ``per``."""
    lo = axis.index * per
    mine = (ids >= lo) & (ids < lo + per)
    return torch.where(mine, ids - lo, torch.full_like(ids, per))


def _owner(ids: torch.Tensor, per: int, n: int) -> torch.Tensor:
    """The owning rank of each exchange id, ``n`` for ``DEAD``."""
    return torch.where(ids >= 0, torch.div(ids, per, rounding_mode="floor"),
                       torch.full_like(ids, n))


def _pick(stack: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
          local: torch.Tensor, per: int) -> torch.Tensor:
    """From ``stack`` ((n, w, ...): block j the rows rank j sent), each
    slot's row from its owner's block at ``pos``; a dead slot's row is
    the local dead row."""
    n, w = stack.shape[0], stack.shape[1]
    owner = _owner(ids, per, n)
    dead = owner == n
    flat = stack.reshape((n * w,) + tuple(stack.shape[2:]))
    rows = flat.index_select(0, torch.where(dead, 0, owner * w + pos))
    keep = dead.reshape((-1,) + (1,) * (rows.ndim - 1))
    return torch.where(keep, local[per].unsqueeze(0), rows)


def gather_rows(local: torch.Tensor, all_ids: torch.Tensor, part: slice,
                axis, sharded: bool) -> torch.Tensor:
    """The rows of this rank's slots ``all_ids[part]`` from their owners.
    ``local``: this rank's ``(per + 1, ...)`` block; ``all_ids``: the
    round's (W,) exchange ids in slot order (the same on every rank).
    ``sharded``: each rank runs its ``W/C`` slots, and block i of the
    ``all_to_all`` carries the rows this rank owns of rank i's slots;
    otherwise every rank runs all W, and one all-gather carries each
    rank's owned rows of the whole round."""
    per = local.shape[0] - 1
    mine = all_ids[part]
    send = local.index_select(0, local_ids(all_ids, per, axis))
    if sharded:
        recv = axis.all_to_all(send.reshape(
            (axis.size, mine.shape[0]) + tuple(local.shape[1:])))
    else:
        recv = axis.all_gather(send)
    pos = torch.arange(recv.shape[1], device=all_ids.device)
    return _pick(recv, mine, pos, local, per)


def scatter_rows(local: torch.Tensor, all_ids: torch.Tensor,
                 new: torch.Tensor, axis, sharded: bool) -> None:
    """Each new row back to its owner, in place. ``new``: this rank's
    slots' new rows (all W slots where not ``sharded``, which every rank
    computed alike, so no row crosses). A row another rank owns, and a
    dead slot's, lands on the local dead row, which is then restored:
    the scatter writes nowhere for them."""
    per = local.shape[0] - 1
    rows = axis.all_gather(new).reshape(
        (-1,) + tuple(new.shape[1:])) if sharded else new
    dead = local[per].clone()
    local.index_copy_(0, local_ids(all_ids, per, axis), rows)
    local[per] = dead



# --- the host store's rows (runtime/fed_model.py) -----------------------

def sum_owned_rows(rows: torch.Tensor, mesh, sharded: bool) -> torch.Tensor:
    """The host store's gather across the mesh (reference
    ``_gather_rows``' ``process_allgather`` sum, runtime/fed_model.py:
    495-515): ``rows`` are the round's W participants' rows as this
    rank's store gave them, its own rows real and every other row
    zeros. Ownership is by world rank, so one sum over the world holds
    each row exactly once; this rank keeps its ``client_slice`` block
    (``sharded``) or all W. The sum runs on the rows' bits as int32: an
    owner's value plus zeros is that value's bits, a ``-0.0`` included,
    so the rows cross bit for bit. On the 1-D mesh one reduce-scatter
    over ``clients``; on the 2-D mesh an all-reduce over ``model`` (the
    M peers of a ``clients`` coordinate own disjoint rows) and then the
    reduce-scatter; unsharded, one all-reduce over the world."""
    bits = rows.contiguous().view(torch.int32)
    if not sharded:
        return mesh.world.psum(bits).view(torch.float32)
    bits = mesh.model.psum(bits)
    n = mesh.clients.size
    blocks = bits.reshape((n, bits.shape[0] // n) + tuple(bits.shape[1:]))
    return mesh.clients.reduce_scatter(blocks).view(torch.float32)


def all_slot_rows(rows: torch.Tensor, mesh, sharded: bool) -> torch.Tensor:
    """The host store's write-back across the mesh: this rank's slots'
    new rows ((W/C, ...) when ``sharded``) all-gathered over
    ``clients`` into the round's (W, ...) slot order, which the model
    peers hold alike; every rank then writes the rows it owns. Where
    every rank ran all W, nothing crosses."""
    if not sharded:
        return rows
    return mesh.clients.all_gather(rows).reshape(
        (-1,) + tuple(rows.shape[1:]))
