"""Rank functions of the port's sequence-parallel tests
(tests/test_torch_ring_attention.py, tests/test_torch_rounds_sp.py,
tests/test_torch_sp_trainer.py,
tests/test_torch_sp_multihost.py).

``commefficient_tpu_torch.parallel.mesh.launch`` spawns the ranks, which
import this module to find their function: it imports torch and the
port only, never JAX. Each function runs in a launched gloo group on the
CPU, builds the ``clients`` x ``seq`` meshes its cases ask for
(``make_sp_mesh``; every rank makes every mesh, in one order) and
returns numpy arrays, which the test compares beside JAX in the parent.
"""

import dataclasses

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from commefficient_tpu_torch.core import rounds_sp
from commefficient_tpu_torch.models.gpt2 import GPT2Config, GPT2DoubleHeads
from commefficient_tpu_torch.parallel import mesh as pm
from commefficient_tpu_torch.parallel import ring_attention as ra


def tasks(items):
    """Several rank functions in one launch: ``items`` is a list of
    (function name in this module, args); returns their results in
    order."""
    return [globals()[name](*args) for name, args in items]


def plain_tree(tree):
    """A parameter tree as nested dicts of numpy arrays: what a rank
    unpickles must not import JAX or flax."""
    if hasattr(tree, "items"):
        return {k: plain_tree(v) for k, v in tree.items()}
    return np.array(tree)


def _meshes(shapes):
    """{(C, N): make_sp_mesh(C, N)} for each shape, made in one order."""
    return {shape: pm.make_sp_mesh(shape[0], shape[1], "cpu")
            for shape in sorted(set(shapes))}


def qkv_inputs(b, t, h, d, seed):
    """q, k, v and the output cotangent, (B, T, H, D) f32, from a numpy
    stream (the tests draw the same for JAX)."""
    rng = np.random.RandomState(seed)
    return [rng.randn(b, t, h, d).astype(np.float32) for _ in range(4)]


def attention_cases(cases):
    """Each case ``{"shape": (C, N), "impl", "causal", "bthd", "seed"}``:
    this rank's sequence shard of the attention output and of dQ, dK,
    dV (the gradient of Σ out·dout), at f32."""
    meshes = _meshes([c["shape"] for c in cases])
    out = []
    for case in cases:
        mesh = meshes[case["shape"]]
        b, t, h, d = case["bthd"]
        q, k, v, do = (torch.from_numpy(x) for x in
                       qkv_inputs(b, t, h, d, case["seed"]))
        tl = t // mesh.n_seq
        cols = slice(mesh.seq.index * tl, (mesh.seq.index + 1) * tl)
        ql, kl, vl = (x[:, cols].clone().requires_grad_(True)
                      for x in (q, k, v))
        fn = (ra.ring_attention if case["impl"] == "ring"
              else ra.ulysses_attention)
        o = fn(ql, kl, vl, mesh.seq, causal=case["causal"])
        o.backward(do[:, cols])
        out.append({"seq": mesh.seq.index, "out": o.detach().numpy(),
                    "dq": ql.grad.numpy(), "dk": kl.grad.numpy(),
                    "dv": vl.grad.numpy()})
    return out


def gpt2_forward_cases(cases, cfg_kw, params, ids, mc_ids, tt):
    """The GPT-2 forward under ``seq_axis`` for each case ``(shape,
    impl)`` on the shards of ``ids``/``tt`` (B, N, T): this rank's
    hidden states (B·N, T/N, C) and the MC logits (B, N)."""
    meshes = _meshes([shape for shape, _ in cases])
    out = []
    for shape, impl in cases:
        mesh = meshes[shape]
        cfg = GPT2Config(**cfg_kw, seq_axis=pm.SEQ_AXIS, seq_impl=impl)
        model = GPT2DoubleHeads(cfg)
        flat = model.from_jax_params(params)
        tl = ids.shape[-1] // mesh.n_seq
        cols = slice(mesh.seq.index * tl, (mesh.seq.index + 1) * tl)
        with torch.no_grad():
            h, _, mc = model(flat, torch.from_numpy(ids[..., cols]),
                             torch.from_numpy(mc_ids),
                             torch.from_numpy(tt[..., cols]),
                             return_hidden=True, seq=mesh.seq)
        out.append({"seq": mesh.seq.index, "h": h.numpy(),
                    "mc": mc.numpy()})
    return out


class VocabWidthRecorder(TorchDispatchMode):
    """The most elements of any f32 tensor an operation makes whose
    last dimension is the vocabulary's, tensors of the tied embedding's
    size (its views and gradient, n_embd x vocab) left out."""

    def __init__(self, vocab, n_embd):
        super().__init__()
        self.vocab, self.weight, self.most = vocab, vocab * n_embd, 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        res = func(*args, **(kwargs or {}))
        for t in (res if isinstance(res, (tuple, list)) else (res,)):
            if (isinstance(t, torch.Tensor) and t.dim() >= 2
                    and t.shape[-1] == self.vocab
                    and t.dtype == torch.float32
                    and t.numel() != self.weight):
                self.most = max(self.most, t.numel())
        return res


def sp_round_cases(cases, cfg_kw, params):
    """Each case ``{"shape", "impl", "batch", "tokens_per_chunk",
    "record"}``: ``build_sp_gpt2_round`` on this rank's shard of
    ``batch`` (the host layout, ``shifted_labels`` included). Returns
    the aggregate (rank 0's; the others report whether theirs is the
    same bits), the (W,) losses, the ``tokens_per_chunk`` each
    ``lm_nll_sums_chunked`` call got and, with ``record``, the largest
    vocabulary-wide f32 tensor the round made (elements)."""
    meshes = _meshes([c["shape"] for c in cases])
    cfg = GPT2Config(**cfg_kw)
    flat = GPT2DoubleHeads(cfg).from_jax_params(params)
    seen = []
    chunked = rounds_sp.lm_nll_sums_chunked

    def capture(*a, **kw):
        seen.append(kw["tokens_per_chunk"])
        return chunked(*a, **kw)

    rounds_sp.lm_nll_sums_chunked = capture
    out = []
    try:
        for case in cases:
            mesh = meshes[case["shape"]]
            fn = rounds_sp.build_sp_gpt2_round(
                dataclasses.replace(cfg, seq_impl=case["impl"]), mesh,
                tokens_per_chunk=case.get("tokens_per_chunk", 0))
            shard = {k: torch.from_numpy(np.asarray(v)) for k, v in
                     rounds_sp.sp_shard(case["batch"], mesh).items()}
            seen.clear()
            rec = (VocabWidthRecorder(cfg.vocab_size, cfg.n_embd)
                   if case.get("record") else None)
            if rec is None:
                agg, losses = fn(flat, shard)
            else:
                with rec:
                    agg, losses = fn(flat, shard)
            every = mesh.world.all_gather(agg)
            out.append({"agg": agg.numpy() if mesh.rank == 0 else None,
                        "same": bool(all(torch.equal(x, agg)
                                         for x in every)),
                        "losses": losses.numpy(), "chunks": list(seen),
                        "vocab_most": None if rec is None else rec.most})
    finally:
        rounds_sp.lm_nll_sums_chunked = chunked
    return out


def gpt2_trainer_runs(argvs):
    """``gpt2_train.main(argv)`` for each of ``argvs`` inside this
    launched rank (main runs the rank's share; it launches nothing):
    each run's result rows, its training rounds' client ids and upload
    byte totals, and its weights' bytes after the run."""
    from commefficient_tpu_torch.runtime import fed_model
    from commefficient_tpu_torch.train import gpt2_train
    base = gpt2_train.SeqParallelFedModel
    out = []
    for argv in argvs:
        rounds = []

        class Recording(base):
            def __call__(self, batch):
                res = super().__call__(batch)
                if self.training:
                    rounds.append((np.asarray(batch["client_ids"]).copy(),
                                   float(np.asarray(res[-1]).sum())))
                return res

        gpt2_train.SeqParallelFedModel = Recording
        try:
            rows = gpt2_train.main(argv)
        finally:
            gpt2_train.SeqParallelFedModel = base
        model = fed_model._CURRENT_MODEL
        out.append({"rows": rows, "rounds": rounds,
                    "ps": model.ps_weights.numpy().tobytes(),
                    "d": int(model.ps_weights.numel()),
                    "sp_shape": dict(model._sp_mesh.shape)})
    return out
