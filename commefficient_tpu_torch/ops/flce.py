"""Fused tied-head cross-entropy (fused-linear-CE) for GPT-2's LM loss.

Port of the parts of ``commefficient_tpu/ops/flce_pallas.py`` the
trainer uses: ``flce_lse_tok`` (:189) as a ``torch.autograd.Function``
whose forward is the flce forward kernel and whose backward is the
flce backward kernel (``ops/flce_kernels.py``, ``csrc/flce.cu``),
``lm_nll_sums_fused`` (:346), ``supported`` (:73) and
``resolve_fused_ce`` (:305). The (tokens, vocab) logits never exist in
device memory.

``FlceLseTok`` and its backward ``FlceBwd`` have ``torch.func``
``vmap`` rules, so the per-client round (``core/grad.py``: every
client's gradient under ``vmap``) runs the kernels too: the forward
once over all clients' tokens, the backward once a client.

Unlike the JAX package, the fused path never falls back to the chunked
one: ``--fused_ce on`` at a width the kernels cannot take raises with
the reason, and on the card it needs bf16 compute (``--bf16``), since
the kernels take bf16 operands only. ``auto`` resolves once, when the
trainer is built: on for a CUDA device at a supported width under
``--bf16``, off otherwise.
"""

from __future__ import annotations

import torch

from commefficient_tpu_torch.ops.flce_kernels import (flce_bwd_kernel,
                                                      flce_fwd_kernel,
                                                      unsupported_reason)


def supported(c: int) -> bool:
    """Whether the kernels take embedding width ``c``."""
    return unsupported_reason(c) is None


def resolve_fused_ce(flag: str, n_embd: int, device,
                     dtype=torch.float32) -> bool:
    """``--fused_ce`` -> whether the LM loss runs the fused kernels.
    "on" raises where they cannot run (an unsupported width anywhere,
    a non-bf16 compute type on the card); "auto" is on exactly where
    "on" would run on a card."""
    if flag not in ("auto", "on", "off"):
        raise ValueError(f"--fused_ce must be auto|on|off, got {flag!r}")
    if flag == "off":
        return False
    on_card = torch.device(device).type == "cuda"
    reason = unsupported_reason(n_embd)
    if reason is None and on_card and dtype != torch.bfloat16:
        reason = (f"compute type {dtype} on the card; the flce kernels "
                  "take bfloat16 only (pass --bf16)")
    if flag == "auto":
        return on_card and reason is None
    if reason is not None:
        raise ValueError(f"--fused_ce on: {reason}")
    return True


def _batched(t, dim, size):
    """``t`` with its batch axis ``dim`` first, (size, ...); an
    unbatched operand (``dim`` None) expanded to it."""
    if dim is None:
        return t.expand((size,) + tuple(t.shape))
    return t.movedim(dim, 0)


class FlceLseTok(torch.autograd.Function):
    """Per-token (logsumexp, label logit) of ``x . w^T``, differentiable
    in x and w; the forward is the flce forward kernel, the backward
    ``FlceBwd`` (the backward kernel).

    Under ``torch.func.vmap`` (the per-client round, core/grad.py) the
    ``vmap`` rule runs the kernels on the unbatched tensors: with x
    batched over clients and w shared, the client axis folds into the
    tokens, one forward launch for (W·M, C); with w batched too, one
    launch a client."""

    @staticmethod
    def forward(x, w, labels):
        return flce_fwd_kernel(x, w, labels)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, labels = inputs
        ctx.save_for_backward(x, w, labels, output[0])

    @staticmethod
    def backward(ctx, g_lse, g_tok):
        x, w, labels, lse = ctx.saved_tensors

        def cot(g):
            if g is None:
                return torch.zeros_like(lse)
            return g.to(torch.float32).contiguous()

        dx, dw = FlceBwd.apply(x, w, labels, lse, cot(g_lse), cot(g_tok))
        return dx, dw, None

    @staticmethod
    def vmap(info, in_dims, x, w, labels):
        n = info.batch_size
        xb, lb = (_batched(t, d, n) for t, d in
                  ((x, in_dims[0]), (labels, in_dims[2])))
        if in_dims[1] is None:
            m = xb.shape[1]
            lse, tok = flce_fwd_kernel(
                xb.reshape((n * m,) + tuple(xb.shape[2:])).contiguous(),
                w, lb.reshape(n * m).contiguous())
            return (lse.reshape(n, m), tok.reshape(n, m)), (0, 0)
        wb = w.movedim(in_dims[1], 0)
        outs = [flce_fwd_kernel(xb[i].contiguous(), wb[i].contiguous(),
                                lb[i].contiguous()) for i in range(n)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)


class FlceBwd(torch.autograd.Function):
    """The flce backward kernel as a Function of its own: (dX, dW) of
    ``g_lse . lse + g_tok . tok``. Its ``vmap`` rule (the backward of a
    vmapped ``FlceLseTok``) launches the kernel once a client: each
    client's dW_i = d_i^T x_i is its own product. Not differentiable
    again."""

    @staticmethod
    def forward(x, w, labels, lse, g_lse, g_tok):
        return flce_bwd_kernel(x, w, labels, lse, g_lse, g_tok)

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, g_dx, g_dw):
        raise NotImplementedError(
            "the fused CE has no second derivative")

    @staticmethod
    def vmap(info, in_dims, x, w, labels, lse, g_lse, g_tok):
        n = info.batch_size
        ops = [_batched(t, d, n) for t, d in
               zip((x, w, labels, lse, g_lse, g_tok), in_dims)]
        outs = [flce_bwd_kernel(*(t[i].contiguous() for t in ops))
                for i in range(n)]
        return (torch.stack([o[0] for o in outs]),
                torch.stack([o[1] for o in outs])), (0, 0)


def flce_lse_tok(x, w, labels):
    """``labels`` must be in range (callers substitute 0 for ignored
    positions and mask outside); nll = lse - tok."""
    return FlceLseTok.apply(x, w, labels)


def lm_nll_sums_fused(h, wte, labels, dtype, ignore_index=-100,
                      tokens_per_chunk=1024):
    """Per-example (Σ nll, Σ valid) of the tied-head LM cross-entropy
    through the fused kernels: the contract of
    ``models/gpt2.py lm_nll_sums_chunked`` (``tokens_per_chunk`` is
    accepted for that contract; the kernels need no chunking). ``h``
    (E, Tm, C) hidden states at the predicting positions, ``labels``
    (E, Tm) the shifted targets."""
    del tokens_per_chunk
    e, tm, c = h.shape
    x = h.to(dtype).reshape(e * tm, c).contiguous()
    w = wte.to(dtype).contiguous()
    lab = labels.reshape(e * tm)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, 0).to(torch.int32).contiguous()
    lse, tok = flce_lse_tok(x, w, safe)
    nll = torch.where(valid, lse - tok, 0.0).reshape(e, tm)
    return nll.sum(1), valid.reshape(e, tm).to(torch.float32).sum(1)
