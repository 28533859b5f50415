"""Sequence parallelism's attention: ring and Ulysses over a ``seq`` axis.

Port of ``commefficient_tpu/parallel/ring_attention.py`` (``_block_attn``
:40, ``ring_attention`` :60, ``ulysses_attention`` :111,
``dense_reference`` :138) onto ``torch.distributed``: q, k and v are a
rank's shards of the sequence, (B, T_local, H, D), and ``axis`` is the
``seq`` axis of ``parallel/mesh.py make_sp_mesh`` (its index is the
shard's place in the sequence).

- ``ring_attention``: exact blockwise attention with an online softmax.
  Each rank keeps its queries; the K and V blocks, cast to f32, travel
  around the ring (``Axis.ring_shift``), and after ``s`` shifts a rank
  holds the block of rank ``(index - s) mod n``. The causal mask comes
  from global positions (query ``index·T + t``), masked scores are the
  finite -1e30, so a block that is wholly in a query's future adds
  nothing; the output is cast back to q's dtype. The gradient is a
  second ring pass (``_Ring.backward``): dQ stays home, and each block's
  dK and dV travel with the block, arriving at their owner after n
  shifts. A rank's clients are folded into B, so one rotation carries
  them all.
- ``ulysses_attention``: an all-to-all from sequence shards to head
  shards (rank j gets heads j·H/n .. (j+1)·H/n - 1 of the whole
  sequence), the model's plain causal attention (``dense_attention``,
  the GPT-2 model's own plain branch) on the full sequence, and the
  inverse all-to-all; the gradient of an all-to-all is the same
  all-to-all of the cotangents. n_head must be a multiple of the axis
  size. The reference's way back (``heads_to_seq``, an all-to-all whose
  concat axis lands after the local heads) interleaves the heads when
  H/n > 1, so it matches dense attention only at one head a rank; this
  one is the exact inverse of the way there at any H/n.
- ``seq_sum``: the sum over the axis of a tensor every shard's
  objective reads whole (the MC head's gathered hidden state); its
  backward is the sum of the cotangents.

The block products stay plain PyTorch, as the reference's are
``jnp.einsum`` outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

# finite mask value: the online softmax stays NaN-free for blocks wholly
# in a query's future
_NEG_INF = -1e30


def _mask(q_owner: int, kv_owner: int, t: int, causal: bool, device):
    """(Tq, Tk) additive mask of the block owned by ``kv_owner`` for the
    queries of ``q_owner``, from global positions."""
    if not causal:
        return torch.zeros(t, t, dtype=torch.float32, device=device)
    pos = torch.arange(t, device=device)
    allowed = (q_owner * t + pos)[:, None] >= (kv_owner * t + pos)[None, :]
    return torch.where(allowed, 0.0, _NEG_INF)


def _scores(q, k, mask, scale):
    """(B, H, Tq, Tk) f32 masked scores of q (B, Tq, H, D) against k."""
    return torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + mask


def _block_attn(q, k, v, mask, o, m, l, scale):
    """One KV block of online-softmax attention (reference :40-57): o
    (B, Tq, H, D) the unnormalised output, m / l (B, Tq, H) the running
    max and normaliser."""
    s = _scores(q, k, mask, scale)
    m_new = torch.maximum(m, s.amax(-1).transpose(1, 2))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new.transpose(1, 2)[..., None])
    l_new = l * corr + p.sum(-1).transpose(1, 2)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bkhd->bqhd", p, v)
    return o_new, m_new, l_new


class _Ring(torch.autograd.Function):
    """Ring attention's forward ring and its backward ring."""

    @staticmethod
    def forward(ctx, q, k, v, axis, causal):
        n, idx = axis.size, axis.index
        b, t, h, d = q.shape
        scale = 1.0 / math.sqrt(d)
        qf = q.float()
        kv = torch.stack([k.float(), v.float()])
        o = torch.zeros(b, t, h, d, dtype=torch.float32, device=q.device)
        m = torch.full((b, t, h), _NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros(b, t, h, dtype=torch.float32, device=q.device)
        for s in range(n):
            owner = (idx - s) % n
            o, m, l = _block_attn(qf, kv[0], kv[1],
                                  _mask(idx, owner, t, causal, q.device),
                                  o, m, l, scale)
            if s < n - 1:
                kv = axis.ring_shift(kv)
        out = o / torch.clamp(l, min=1e-30)[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.axis, ctx.causal = axis, causal
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        axis, causal = ctx.axis, ctx.causal
        n, idx = axis.size, axis.index
        t, d = q.shape[1], q.shape[3]
        scale = 1.0 / math.sqrt(d)
        qf, do = q.float(), dout.float()
        lse_t = lse.transpose(1, 2)[..., None]
        di_t = (do * out).sum(-1).transpose(1, 2)[..., None]
        dq = torch.zeros_like(qf)
        kv = torch.stack([k.float(), v.float()])
        dkv = torch.zeros_like(kv)  # the held block's dK and dV so far
        for s in range(n):
            owner = (idx - s) % n
            p = torch.exp(_scores(qf, kv[0], _mask(idx, owner, t, causal,
                                                   q.device), scale) - lse_t)
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, kv[1]) - di_t)
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kv[0]) * scale
            dkv[0] += torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            dkv[1] += torch.einsum("bhqk,bqhd->bkhd", p, do)
            # the gradients move on with their block, n shifts in all,
            # the last bringing them home to the block's owner; K and V
            # stop after the last block product
            if s < n - 1:
                both = axis.ring_shift(torch.cat([kv, dkv]))
                kv, dkv = both[:2], both[2:]
            else:
                dkv = axis.ring_shift(dkv)
        return (dq.to(q.dtype), dkv[0].to(k.dtype), dkv[1].to(v.dtype),
                None, None)


def ring_attention(q, k, v, axis, causal: bool = True):
    """Exact attention of this rank's query shard over the whole
    sequence (reference :60-108); q, k, v (B, T_local, H, D)."""
    return _Ring.apply(q, k, v, axis, causal)


class _AllToAll(torch.autograd.Function):
    """``Axis.all_to_all`` of (n, ...) blocks; its own adjoint."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.all_to_all(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.all_to_all(g), None


def dense_attention(q, k, v, causal: bool = True):
    """Plain softmax attention on (B, H, T, hd) q, k, v (the GPT-2
    model's plain branch, the port's counterpart of
    ``jax.nn.dot_product_attention``): f32 scores from the compute-type
    q and k at scale hd^-1/2, the causal mask, an f32 softmax and the
    probabilities cast back to the compute type before the value
    product."""
    t = q.shape[-2]
    scores = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return probs @ v


def ulysses_attention(q, k, v, axis, causal: bool = True):
    """All-to-all sequence parallelism (reference :111-135): sequence
    shards -> head shards, ``dense_attention`` on the whole sequence,
    head shards -> sequence shards. q, k, v (B, T_local, H, D)."""
    n = axis.size
    b, t, h, d = q.shape
    if h % n:
        raise ValueError(f"ulysses attention: n_head {h} is not a "
                         f"multiple of the seq axis size {n}")

    def seq_to_heads(x):
        # block j (heads j·h/n ..) to rank j; the blocks that come back
        # are the sequence shards in rank order
        x = x.reshape(b, t, n, h // n, d).permute(2, 0, 1, 3, 4)
        x = _AllToAll.apply(x.contiguous(), axis)
        return x.permute(1, 3, 0, 2, 4).reshape(b, h // n, n * t, d)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    out = dense_attention(qh, kh, vh, causal)  # (B, h/n, T, D)
    out = out.reshape(b, h // n, n, t, d).permute(2, 0, 3, 1, 4)
    out = _AllToAll.apply(out.contiguous(), axis)
    # received: (head group, B, T_local, h/n, D)
    return out.permute(1, 2, 0, 3, 4).reshape(b, t, h, d)


def dense_reference(q, k, v, causal: bool = True):
    """One device's attention of (B, T, H, D) q, k, v: the oracle of the
    tests and the card's checks (reference :138-140)."""
    out = dense_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal)
    return out.transpose(1, 2)


class _SeqSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return axis.psum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return ctx.axis.psum(g.contiguous().clone()), None


def seq_sum(x, axis):
    """The sum of ``x`` over ``axis``, whose backward sums the
    cotangents: every shard's objective reads the whole sum, so the
    gradient of one shard's addend is the sum of theirs."""
    return _SeqSum.apply(x, axis)
