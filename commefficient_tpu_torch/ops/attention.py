"""Causal flash attention for GPT-2's ``--attn_impl flash``.

Port of the call ``commefficient_tpu/models/gpt2.py:122-135`` makes:
JAX's library ``flash_attention(q, k, v, causal=True, sm_scale=...,
block_sizes=...)`` with every block the first of 512, 256, 128 that
divides T. ``FlashAttention`` is its ``custom_vjp``
(flash_attention.py:196-318) as a ``torch.autograd.Function``: the
forward runs the forward kernel and saves (q, k, v, o, m, l); the
backward computes di = sum(o * do) over the head dim (XLA code in the
reference, a PyTorch reduction here), then dK/dV, then dQ, each a
kernel (``ops/attention_kernels.py``, ``csrc/flash_attn.cu``).

``flash_attention`` runs the kernels for CUDA tensors and the plain
versions for CPU tensors; it never switches between them on error.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.ops.attention_kernels import (
    attn_bwd_dkv_kernel, attn_bwd_dq_kernel, attn_fwd_kernel,
    attn_fwd_plain, unsupported_reason)

__all__ = ["FlashAttention", "flash_attention", "flash_attention_plain",
           "unsupported_reason"]


def flash_attention_plain(q, k, v, sm_scale):
    """The plain PyTorch version of the library's causal forward on
    (B, H, T, hd) operands: o in q's type."""
    return attn_fwd_plain(q, k, v, sm_scale)[0]


class FlashAttention(torch.autograd.Function):
    """Causal attention of (B, H, T, hd) q, k, v, differentiable in all
    three."""

    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        o, m, l = attn_fwd_kernel(q, k, v, sm_scale)
        ctx.save_for_backward(q, k, v, o, m, l)
        ctx.sm_scale = sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, m, l = ctx.saved_tensors
        di = (o.float() * do.float()).sum(-1).contiguous()
        dk, dv = attn_bwd_dkv_kernel(q, k, v, m, l, do, di, ctx.sm_scale)
        dq = attn_bwd_dq_kernel(q, k, v, m, l, do, di, ctx.sm_scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, sm_scale):
    """Causal attention of (B, H, T, hd) q, k, v with scores scaled by
    ``sm_scale``, T a multiple of 128 -> o (B, H, T, hd) in q's type."""
    return FlashAttention.apply(q, k, v, sm_scale)
