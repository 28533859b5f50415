"""The federated GPT-2 round with sequence parallelism inside each
client: the ``clients`` x ``seq`` mesh.

Port of ``commefficient_tpu/core/rounds_sp.py`` (``shift_lm_labels``
:67, ``build_sp_gpt2_round`` :77) onto the ranks of
``parallel/mesh.py make_sp_mesh``: rank c·N + s holds clients
c·W/C .. (c+1)·W/C - 1 of the round and positions s·T/N .. (s+1)·T/N - 1
of their sequences (``sp_shard``). Its clients are folded into the
batch, so one forward over the rank's shard runs them all, the
attention a ring (or Ulysses) over ``seq`` (models/gpt2.py).

The objective is the reference's, a rank's exact share of the round's:
for each client, the LM numerator of its local tokens over its global
valid count (summed over ``seq``, no gradient), plus ``mc_coef·mc / N``
(every shard reads the same MC logits), weighted by ``w_c``, whether
the client has a real example. The LM term is
``lm_nll_sums_chunked`` on the local shard, chunked as the reference
chunks one client (``tokens_per_chunk``, 0 = 256 tokens a client a
chunk): no (tokens, V) logits tensor beyond one chunk is made.
``--fused_ce`` does not apply here. After the rank's backward the flat
gradient is summed over the world (shard_map's implicit sum in the
reference) and divided by the participating clients, summed over
``clients``. Clients weigh equally and a client's LM loss is a token
mean over all its valid tokens: the reference's deliberate differences
from the 1-D round (runtime/fed_model_sp.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from commefficient_tpu_torch.models.gpt2 import (GPT2Config, GPT2DoubleHeads,
                                                 lm_nll_sums_chunked,
                                                 token_nll)
from commefficient_tpu_torch.parallel.mesh import SEQ_AXIS

# the round's token arrays (W, B, N, T) and per-client arrays
TOKEN_KEYS = ("input_ids", "token_type_ids", "shifted_labels")
CLIENT_KEYS = ("mc_token_ids", "mc_labels", "mask")


def shift_lm_labels(lm_labels, ignore_index: int = -1) -> np.ndarray:
    """Host-side global shift (reference :67-74): position t is labelled
    with token t + 1 and the last position with ``ignore_index``, so a
    shard never needs its right neighbour's first token."""
    shifted = np.roll(np.asarray(lm_labels), -1, axis=-1)
    shifted[..., -1] = ignore_index
    return shifted


def sp_shard(batch: dict, mesh) -> dict:
    """This rank's part of a host round batch (the keys of
    ``build_sp_gpt2_round``): its clients' rows, and of their token
    arrays its positions. W must divide over ``clients`` and T over
    ``seq``."""
    w, t = batch["input_ids"].shape[0], batch["input_ids"].shape[-1]
    c, n = mesh.n_clients, mesh.n_seq
    if w % c:
        raise ValueError(f"num_workers {w} must be divisible by the "
                         f"client axis {c}")
    if t % n:
        raise ValueError(f"sequence length {t} must be divisible by the "
                         f"seq axis {n}")
    wl, tl = w // c, t // n
    rows = slice(mesh.clients.index * wl, (mesh.clients.index + 1) * wl)
    cols = slice(mesh.seq.index * tl, (mesh.seq.index + 1) * tl)
    out = {k: np.asarray(batch[k])[rows, ..., cols] for k in TOKEN_KEYS}
    out.update({k: np.asarray(batch[k])[rows] for k in CLIENT_KEYS})
    return out


def build_sp_gpt2_round(cfg: GPT2Config, mesh, lm_coef: float = 1.0,
                        mc_coef: float = 1.0, ignore_index: int = -1,
                        tokens_per_chunk: int = 0):
    """``round(flat, shard) -> (aggregate (d,), losses (W,))`` on this
    rank of ``mesh`` (``make_sp_mesh``). ``shard`` is ``sp_shard`` of
    the round's batch on the device: ``input_ids``/``token_type_ids``/
    ``shifted_labels`` (W/C, B, N, T/N) (labels from
    ``shift_lm_labels``), ``mc_token_ids`` (W/C, B, N) global
    positions, ``mc_labels`` (W/C, B), ``mask`` (W/C, B) per example.
    The aggregate is the same on every rank; the losses are the round's
    W clients', zero for a client with no real example."""
    model = GPT2DoubleHeads(dataclasses.replace(cfg, seq_axis=SEQ_AXIS))
    per_client = tokens_per_chunk or 256
    seq, clients, world = mesh.seq, mesh.clients, mesh.world

    def round_fn(flat, shard):
        ids = shard["input_ids"]
        wl, b, n, tl = ids.shape
        mask = shard["mask"].to(torch.float32)
        w = (torch.sum(mask, dim=1) > 0).to(torch.float32)
        f = flat.detach().requires_grad_(True)
        with torch.enable_grad():
            h, wte, mc_logits = model(
                f, ids.reshape(wl * b, n, tl),
                shard["mc_token_ids"].reshape(wl * b, n),
                shard["token_type_ids"].reshape(wl * b, n, tl),
                return_hidden=True, seq=seq)
            sn, sv = lm_nll_sums_chunked(
                h, wte, shard["shifted_labels"].reshape(-1, tl), cfg.dtype,
                ignore_index=ignore_index,
                tokens_per_chunk=per_client * wl)
            e_mask = mask[:, :, None]
            lm_sum = torch.sum(sn.reshape(wl, b, n) * e_mask, dim=(1, 2))
            lm_cnt = torch.sum(sv.reshape(wl, b, n) * e_mask, dim=(1, 2))
            mc_nll, _ = token_nll(mc_logits[..., None, :],
                                  shard["mc_labels"].reshape(-1, 1),
                                  ignore_index)
            mc = (torch.sum(mc_nll[:, 0].reshape(wl, b) * mask, dim=1)
                  / torch.clamp(torch.sum(mask, dim=1), min=1.0))
            # the clients' global LM numerators and valid counts
            tot = seq.psum(torch.stack([lm_sum.detach(), lm_cnt.detach()]))
            count = torch.clamp(tot[1], min=1.0)
            share = lm_coef * lm_sum / count + mc_coef * mc / seq.size
            (g,) = torch.autograd.grad(torch.sum(share * w), f)
        g = world.psum(g)
        n_clients = torch.clamp(clients.psum(torch.sum(w).reshape(1)),
                                min=1.0)
        report = lm_coef * tot[0] / count + mc_coef * mc.detach()
        losses = clients.all_gather(report * w).reshape(-1)
        return g / n_clients[0], losses

    return round_fn
