"""Causal flash attention for GPT-2's ``--attn_impl flash``.

Port of the call ``commefficient_tpu/models/gpt2.py:122-135`` makes:
JAX's library ``flash_attention(q, k, v, causal=True, sm_scale=...,
block_sizes=...)`` with every block the first of 512, 256, 128 that
divides T. ``FlashAttention`` is its ``custom_vjp``
(flash_attention.py:196-318) as a ``torch.autograd.Function``: the
forward runs the forward kernel and saves (q, k, v, o, m, l); the
backward, ``FlashAttentionBwd``, computes di = sum(o * do) over the
head dim (XLA code in the reference, a PyTorch reduction here), then
dK/dV, then dQ, each a kernel (``ops/attention_kernels.py``,
``csrc/flash_attn.cu``). Both have ``torch.func`` ``vmap`` rules that
fold a client axis into B, so GPT-2's per-client round (every client's
gradient under ``vmap``) launches each kernel once over all clients,
as the fused round does.

``flash_attention`` runs the kernels for CUDA tensors and the plain
versions for CPU tensors; it never switches between them on error.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.ops.attention_kernels import (
    attn_bwd_dkv_kernel, attn_bwd_dq_kernel, attn_fwd_kernel,
    attn_fwd_plain, unsupported_reason)

__all__ = ["FlashAttention", "FlashAttentionBwd", "flash_attention",
           "flash_attention_plain", "unsupported_reason"]


def flash_attention_plain(q, k, v, sm_scale):
    """The plain PyTorch version of the library's causal forward on
    (B, H, T, hd) operands: o in q's type."""
    return attn_fwd_plain(q, k, v, sm_scale)[0]


def _fold(t, dim, size):
    """A vmapped operand with its client axis ``dim`` (None: unbatched,
    expanded) folded into its leading axis: (size * B, ...)."""
    t = t.expand((size,) + tuple(t.shape)) if dim is None \
        else t.movedim(dim, 0)
    return t.reshape((size * t.shape[1],) + tuple(t.shape[2:]))


def _unfold(t, size):
    """(size * B, ...) -> (size, B, ...), a view."""
    return t.reshape((size, t.shape[0] // size) + tuple(t.shape[1:]))


class FlashAttention(torch.autograd.Function):
    """Causal attention of (B, H, T, hd) q, k, v, differentiable in all
    three: -> (o, m, l), o in q's type, the row statistics m and l f32
    (B, H, T) for the backward (``FlashAttentionBwd``).

    Under ``torch.func.vmap`` (GPT-2's per-client round, core/grad.py)
    the ``vmap`` rule folds the client axis into B, any operand may be
    unbatched, and the forward kernel launches once over every client's
    sequences. No launch ever sees a batched tensor."""

    @staticmethod
    def forward(q, k, v, sm_scale):
        return attn_fwd_kernel(q, k, v, sm_scale)

    @staticmethod
    def setup_context(ctx, inputs, output):
        q, k, v, sm_scale = inputs
        o, m, l = output
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.sm_scale = sm_scale

    @staticmethod
    def backward(ctx, do, dm, dl):
        # m and l are statistics for the backward, not results: their
        # cotangents are ignored
        q, k, v, o, m, l = ctx.saved_tensors
        dq, dk, dv = FlashAttentionBwd.apply(q, k, v, o, m, l, do,
                                             ctx.sm_scale)
        return dq, dk, dv, None

    @staticmethod
    def vmap(info, in_dims, q, k, v, sm_scale):
        n = info.batch_size
        o, m, l = attn_fwd_kernel(*(_fold(t, d, n) for t, d in
                                    zip((q, k, v), in_dims[:3])), sm_scale)
        return (_unfold(o, n), _unfold(m, n), _unfold(l, n)), (0, 0, 0)


class FlashAttentionBwd(torch.autograd.Function):
    """The backward as a Function of its own: di = sum(o * do) over the
    head dim (a PyTorch reduction, XLA code in the reference), then the
    dK/dV and dQ kernels -> (dq, dk, dv). Its ``vmap`` rule (the backward
    of a vmapped ``FlashAttention``) folds the client axis into B as the
    forward's does: one dK/dV and one dQ launch over every client. Not
    differentiable again."""

    @staticmethod
    def forward(q, k, v, o, m, l, do, sm_scale):
        di = (o.float() * do.float()).sum(-1).contiguous()
        dk, dv = attn_bwd_dkv_kernel(q, k, v, m, l, do, di, sm_scale)
        dq = attn_bwd_dq_kernel(q, k, v, m, l, do, di, sm_scale)
        return dq, dk, dv

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g_dq, g_dk, g_dv):
        raise NotImplementedError(
            "the flash attention has no second derivative")

    @staticmethod
    def vmap(info, in_dims, q, k, v, o, m, l, do, sm_scale):
        n = info.batch_size
        grads = FlashAttentionBwd.forward(
            *(_fold(t, d, n) for t, d in
              zip((q, k, v, o, m, l, do), in_dims[:7])), sm_scale)
        return tuple(_unfold(g, n) for g in grads), (0, 0, 0)


def flash_attention(q, k, v, sm_scale):
    """Causal attention of (B, H, T, hd) q, k, v with scores scaled by
    ``sm_scale``, T a multiple of 128 -> o (B, H, T, hd) in q's type."""
    return FlashAttention.apply(q, k, v, sm_scale)[0]
