"""GPT-2 with double heads (LM + multiple-choice).

Port of ``commefficient_tpu/models/gpt2.py`` (``GPT2Config`` :35,
``MLP`` :82, ``CausalSelfAttention`` :95 with its XLA branch,
``Block`` :149, ``GPT2Transformer`` :164, ``GPT2DoubleHeads`` :190,
``token_nll`` :243, ``lm_nll_sums_chunked`` :257).

As for ResNet9, the parameters are not registered on the modules:
``forward(flat, ...)`` views the flat f32 vector (``ops/vec.py``,
ravel_pytree order) as the flax leaves. Sorted keys put ``mc_head``
before ``transformer`` and the blocks in the order h_0, h_1, h_10,
h_11, h_2, ...; Dense kernels stay (in, out).

Numerics follow the flax model: GELU in its tanh form; causal
attention with scale hd^-1/2 and no padding mask, its scores and
softmax in f32; ``token_type_ids`` index ``wte``, so ``wte``'s
gradient gets embedding, token-type and tied-head terms; the MC head
reads the hidden state at ``clip(mc_token_ids, 0, T-1)`` and computes
in f32. With ``dtype=torch.bfloat16`` (``--bf16``) the residual stream
and the LayerNorms stay f32, Dense layers compute in bf16 and LM
logits accumulate in f32.

``attn_impl="flash"`` (``--attn_impl flash``) runs the attention of a
sequence whose length is a multiple of 128 through the flash attention
kernels (``ops/attention.py``), as the reference runs JAX's library
flash attention there (gpt2.py:115-135); other lengths take the plain
branch, as in the reference. ``remat=True`` (``--remat``) recomputes
each block's activations in the backward
(``torch.utils.checkpoint``, the reference's ``nn.remat(Block)``,
gpt2.py:183).

Sequence parallelism (reference gpt2.py:46-56, 109-114, 176-178,
222-231): with ``seq_axis`` set, ``forward`` takes the ``seq`` axis of
``parallel/mesh.py make_sp_mesh`` (``seq=``) and token arrays sharded
on T over it; position embeddings are global (``pos + index·T``),
attention is ring or Ulysses (``seq_impl``, parallel/ring_attention.py;
the flash branch is not taken), and the MC head reads the hidden state
at the global position ``clip(mc_token_ids, 0, n·T - 1)``: each shard
contributes a one-hot product and the sum over ``seq`` (whose backward
sums the cotangents) gives every shard the whole. Hidden states and LM
logits stay sequence-sharded.

Weights in and out: ``convert_torch_gpt2`` (reference :399) reads a
``transformers`` GPT-2 state dict, ``convert_gpt2_to_hf`` (:327) writes
one with its HF config, ``saved_config`` is the ``config.json`` that
``FedModel.save_pretrained`` writes beside ``flax_model.msgpack``, and
``GPT2DoubleHeads.to_params_tree`` turns the flat vector back into the
flax tree (the inverse of ``from_jax_params``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from commefficient_tpu_torch.models import register_model
from commefficient_tpu_torch.ops.attention import flash_attention
from commefficient_tpu_torch.ops.vec import (flat_size, flatten_params,
                                             params_tree, ravel_order,
                                             unravel)
from commefficient_tpu_torch.parallel.ring_attention import (
    dense_attention, ring_attention, seq_sum, ulysses_attention)


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    # computation dtype of the Dense layers (parameters stay float32)
    dtype: torch.dtype = torch.float32
    # sequence parallelism: the name of the axis the token arrays are
    # sharded over (the forward then takes that axis as ``seq=``), and
    # its attention, "ring" or "ulysses" (n_head a multiple of the
    # axis size)
    seq_axis: Optional[str] = None
    seq_impl: str = "ring"
    # attention lowering: "xla" = the plain causal softmax (the
    # reference's jax.nn.dot_product_attention branch), "flash" = the
    # flash attention kernels where T % 128 == 0
    attn_impl: str = "xla"
    # recompute each block's activations in the backward
    remat: bool = False

    @staticmethod
    def tiny() -> "GPT2Config":
        """Test-scale config (the reference's ``GPT2Config.tiny``)."""
        return GPT2Config(vocab_size=256, n_positions=64, n_embd=32,
                          n_layer=2, n_head=2)


def _dense_shapes(n_in, n_out):
    return {"kernel": (n_in, n_out), "bias": (n_out,)}


def _ln_shapes(n):
    return {"scale": (n,), "bias": (n,)}


def _dense(x, p, dtype):
    """flax ``nn.Dense(dtype=dtype)``: input, kernel and bias cast to
    ``dtype``, (in, out) kernel."""
    return F.linear(x.to(dtype), p["kernel"].to(dtype).t(),
                    p["bias"].to(dtype))


def _layer_norm(x, p, eps):
    return F.layer_norm(x, x.shape[-1:], p["scale"], p["bias"], eps)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg

    def leaf_shapes(self):
        c = self.cfg.n_embd
        return {"c_fc": _dense_shapes(c, 4 * c),
                "c_proj": _dense_shapes(4 * c, c)}

    def forward(self, p, x):
        h = F.gelu(_dense(x, p["c_fc"], self.cfg.dtype), approximate="tanh")
        return _dense(h, p["c_proj"], self.cfg.dtype)


class CausalSelfAttention(nn.Module):
    """One fused qkv projection, causal softmax attention: with
    ``attn_impl="flash"`` and T % 128 == 0 the flash attention kernels
    (the reference's library flash attention, scale hd^-1/2, every
    block the first of 512, 256, 128 dividing T), else the reference's
    ``jax.nn.dot_product_attention`` branch (f32 scores from the
    compute-type q, k, f32 softmax, probabilities cast back to the
    compute type before the value product)."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg

    def leaf_shapes(self):
        c = self.cfg.n_embd
        return {"c_attn": _dense_shapes(c, 3 * c),
                "c_proj": _dense_shapes(c, c)}

    def forward(self, p, x, seq=None):
        b, t, c = x.shape
        h = self.cfg.n_head
        qkv = _dense(x, p["c_attn"], self.cfg.dtype)
        if seq is not None:
            # (B, T_local, H, hd) shards of the sequence
            q, k, v = (z.reshape(b, t, h, c // h)
                       for z in qkv.split(c, dim=-1))
            attn = (ring_attention if self.cfg.seq_impl == "ring"
                    else ulysses_attention)
            out = attn(q, k, v, seq, causal=True).reshape(b, t, c)
            return _dense(out, p["c_proj"], self.cfg.dtype)
        q, k, v = (z.reshape(b, t, h, c // h).transpose(1, 2)
                   for z in qkv.split(c, dim=-1))
        if self.cfg.attn_impl == "flash" and t % 128 == 0:
            # the (B, H, T, hd) views of qkv go in as they are (the
            # kernels read their strides); o comes back as a view of a
            # (B, T, H, hd) tensor
            out = flash_attention(q, k, v, float((c // h) ** -0.5))
            out = out.transpose(1, 2).reshape(b, t, c)
            return _dense(out, p["c_proj"], self.cfg.dtype)
        out = dense_attention(q, k, v).transpose(1, 2).reshape(b, t, c)
        return _dense(out, p["c_proj"], self.cfg.dtype)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.attn = CausalSelfAttention(cfg)
        self.mlp = MLP(cfg)

    def leaf_shapes(self):
        c = self.cfg.n_embd
        return {"attn": self.attn.leaf_shapes(), "ln_1": _ln_shapes(c),
                "ln_2": _ln_shapes(c), "mlp": self.mlp.leaf_shapes()}

    def forward(self, p, x, seq=None):
        eps = self.cfg.layer_norm_epsilon
        dt = self.cfg.dtype
        x = x + self.attn(p["attn"], _layer_norm(x, p["ln_1"], eps).to(dt),
                          seq)
        x = x + self.mlp(p["mlp"], _layer_norm(x, p["ln_2"], eps).to(dt))
        return x


class GPT2Transformer(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.cfg = cfg
        self.block = Block(cfg)  # stateless: one instance serves h_i

    def leaf_shapes(self):
        cfg = self.cfg
        shapes = {f"h_{i}": self.block.leaf_shapes()
                  for i in range(cfg.n_layer)}
        shapes.update(ln_f=_ln_shapes(cfg.n_embd),
                      wpe=(cfg.n_positions, cfg.n_embd),
                      wte=(cfg.vocab_size, cfg.n_embd))
        return shapes

    def forward(self, p, input_ids, token_type_ids=None, seq=None):
        cfg = self.cfg
        t = input_ids.shape[1]
        wte = p["wte"]
        if seq is None:
            pos = p["wpe"][:t]
        else:
            # T is the local shard: global positions (clamped into the
            # table, as JAX's gather clamps)
            idx = torch.arange(t, device=input_ids.device) + seq.index * t
            pos = p["wpe"][torch.clamp(idx, max=cfg.n_positions - 1)]
        h = F.embedding(input_ids.long(), wte) + pos[None]
        if token_type_ids is not None:
            # token types index the same embedding table, GPT-2 style
            h = h + F.embedding(token_type_ids.long(), wte)
        remat = cfg.remat and torch.is_grad_enabled()
        for i in range(cfg.n_layer):
            if remat:
                h = checkpoint(self.block, p[f"h_{i}"], h, seq,
                               use_reentrant=False)
            else:
                h = self.block(p[f"h_{i}"], h, seq)
        return _layer_norm(h, p["ln_f"], cfg.layer_norm_epsilon), wte


@register_model("GPT2DoubleHeads")
class GPT2DoubleHeads(nn.Module):
    """LM logits + per-candidate MC logits. ``return_hidden=True``
    returns the final hidden states and the tied embedding instead of
    the LM logits, for the chunked or fused LM loss."""

    def __init__(self, cfg: GPT2Config = GPT2Config()):
        super().__init__()
        self.cfg = cfg
        self.transformer = GPT2Transformer(cfg)

    def leaf_shapes(self):
        return {"mc_head": _dense_shapes(self.cfg.n_embd, 1),
                "transformer": self.transformer.leaf_shapes()}

    @property
    def num_params(self) -> int:
        return flat_size(self.leaf_shapes())

    def init_flat(self, seed: int, device="cpu") -> torch.Tensor:
        """Random flat parameters from ``seed`` with flax's initializers:
        normal(0, initializer_range) for Dense kernels and embeddings,
        zero biases, unit LayerNorm scales. Drawn on the CPU from a
        seeded generator; the draws differ from jax.random's (tests
        carry JAX weights over with ``from_jax_params``)."""
        gen = torch.Generator().manual_seed(int(seed))
        parts = []
        for path, shape in ravel_order(self.leaf_shapes()):
            n = math.prod(shape)
            if path[-1] == "bias":
                parts.append(torch.zeros(n))
            elif path[-1] == "scale":
                parts.append(torch.ones(n))
            else:
                parts.append(torch.randn(n, generator=gen)
                             * self.cfg.initializer_range)
        return torch.cat(parts).to(device)

    def from_jax_params(self, params_np: dict, device="cpu") -> torch.Tensor:
        """The JAX package's flax parameter tree, as numpy arrays -> the
        port's flat vector (bit-identical to ravel_pytree)."""
        want = [(p, tuple(s)) for p, s in ravel_order(self.leaf_shapes())]
        got = [(p, tuple(a.shape)) for p, a in ravel_order(params_np)]
        if want != got:
            raise ValueError(f"parameter tree mismatch: {got} != {want}")
        return flatten_params(params_np, device)

    def to_params_tree(self, flat: torch.Tensor) -> dict:
        """The flat vector -> the flax parameter tree as numpy f32
        arrays, keys sorted as flax's tree is (the inverse of
        ``from_jax_params``)."""
        return params_tree(flat, self.leaf_shapes())

    def forward(self, flat, input_ids, mc_token_ids, token_type_ids=None,
                return_hidden=False, seq=None):
        """input_ids / token_type_ids (B, N, T), mc_token_ids (B, N) ->
        (lm_logits (B, N, T, V) f32, mc_logits (B, N) f32), or with
        ``return_hidden`` ((B*N, T, C) hidden states, wte, mc_logits).
        Under ``cfg.seq_axis`` ``seq`` is that axis, T the local shard
        and ``mc_token_ids`` global positions."""
        if (self.cfg.seq_axis is None) != (seq is None):
            raise ValueError(
                f"GPT2Config.seq_axis={self.cfg.seq_axis!r} needs the "
                "forward's seq axis (and a seq axis needs seq_axis set): "
                "call it on the seq axis of make_sp_mesh")
        p = unravel(flat, self.leaf_shapes())
        b, n, t = input_ids.shape
        tt = (token_type_ids.reshape(b * n, t)
              if token_type_ids is not None else None)
        h, wte = self.transformer(p["transformer"],
                                  input_ids.reshape(b * n, t), tt, seq)
        h4 = h.reshape(b, n, t, -1)
        if seq is not None:
            # the owning shard contributes its hidden state, the sum
            # over seq hands it to every shard
            gpos = torch.arange(t, device=h.device) + seq.index * t
            idx = torch.clamp(mc_token_ids.long(), 0, seq.size * t - 1)
            sel = (gpos[None, None, :] == idx[..., None]).to(h4.dtype)
            cls_h = seq_sum(torch.einsum("bnt,bntc->bnc", sel, h4), seq)
        else:
            idx = torch.clamp(mc_token_ids.long(), 0, t - 1)
            cls_h = torch.gather(
                h4, 2,
                idx[..., None, None].expand(b, n, 1, h4.shape[-1]))[:, :, 0]
        mc = p["mc_head"]
        mc_logits = (cls_h @ mc["kernel"] + mc["bias"])[..., 0]
        if return_hidden:
            return h, wte, mc_logits
        dt = self.cfg.dtype
        lm_logits = h.to(dt).float() @ wte.to(dt).float().t()
        return lm_logits.reshape(b, n, t, -1), mc_logits


def token_nll(logits, labels, ignore_index=-100):
    """(..., T, V) logits + (..., T) labels -> ((..., T) f32 NLL,
    (..., T) f32 validity), by logsumexp minus the label's logit."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits.float(), dim=-1)
    tok = torch.gather(logits, -1, safe[..., None])[..., 0].float()
    return lse - tok, valid.to(torch.float32)


def gpt2_double_heads_loss(lm_logits, mc_logits, lm_labels, mc_labels,
                           lm_coef=1.0, mc_coef=1.0, ignore_index=-100):
    """lm_coef * CE(LM, shifted) + mc_coef * CE(MC) (reference
    gpt2.py:310): returns (loss, lm_loss, mc_loss), each a scalar mean
    over the valid positions / the examples."""
    nll, valid = token_nll(lm_logits[..., :-1, :], lm_labels[..., 1:],
                           ignore_index)
    lm_loss = torch.sum(nll * valid) / torch.clamp(torch.sum(valid), min=1)
    mc_nll, _ = token_nll(mc_logits[..., None, :], mc_labels[..., None],
                          ignore_index)
    mc_loss = torch.mean(mc_nll[..., 0])
    return lm_coef * lm_loss + mc_coef * mc_loss, lm_loss, mc_loss


def _chunk_sums(hc, lc, wf, ignore_index):
    nll, valid = token_nll(hc @ wf.t(), lc, ignore_index)
    return torch.sum(nll * valid, -1), torch.sum(valid, -1)


def lm_nll_sums_chunked(h, wte, labels, dtype, ignore_index=-100,
                        tokens_per_chunk=1024):
    """Per-example (Σ nll, Σ valid) of the tied-head LM cross-entropy
    without the whole (E, T, V) logits tensor: the tokens go through
    in chunks of ``tokens_per_chunk // E`` positions, each chunk's
    logits recomputed in the backward (``torch.utils.checkpoint``, as
    the reference's ``jax.checkpoint``). ``h`` (E, Tm, C) are the
    final hidden states at the predicting positions, ``labels`` (E,
    Tm) the shifted targets. The operands are rounded to ``dtype`` and
    multiplied in f32 (the reference's bf16 product with f32
    accumulation). Under a ``torch.func`` transform (the per-client
    round) every chunk's logits are kept for the backward instead: the
    same numbers, more memory, and no ``torch.utils.checkpoint``, which
    does not compose with ``torch.func``."""
    e, tm, _ = h.shape
    tc = max(1, min(tm, tokens_per_chunk // max(e, 1)))
    hf = h.to(dtype).float()
    wf = wte.to(dtype).float()
    sn = torch.zeros(e, dtype=torch.float32, device=h.device)
    sv = torch.zeros(e, dtype=torch.float32, device=h.device)
    recompute = (torch.is_grad_enabled()
                 and torch._C._functorch.peek_interpreter_stack() is None)
    for i in range(0, tm, tc):
        hc, lc = hf[:, i:i + tc], labels[:, i:i + tc]
        if recompute:
            n, v = checkpoint(_chunk_sums, hc, lc, wf, ignore_index,
                              use_reentrant=False)
        else:
            n, v = _chunk_sums(hc, lc, wf, ignore_index)
        sn, sv = sn + n, sv + v
    return sn, sv


def saved_config(cfg: GPT2Config) -> dict:
    """The ``config.json`` of a saved run (reference
    ``FedModel.save_pretrained``, fed_model.py:623-628): the config's
    fields whose values are int, float, str, bool or None, in the
    reference's field order. ``dtype`` (a torch dtype here, a jnp dtype
    there) is not such a value."""
    out = {}
    for key, val in dataclasses.asdict(cfg).items():
        if isinstance(val, (int, float, str, bool, type(None))):
            out[key] = val
    return out


def config_from_saved(blob: dict) -> GPT2Config:
    """The architecture of a saved ``config.json`` (a run's, or an HF
    export's), as the reference's reload reads it (gpt2_train.py:
    292-305): the GPT2Config fields it names, without ``attn_impl`` (a
    runtime choice, not architecture). ``seq_axis`` and ``seq_impl``
    are read as the reference reads them: a model whose config names a
    ``seq_axis`` runs only on that axis (its forward raises without
    one, as the reference's fails outside ``shard_map``)."""
    fields = {f.name for f in dataclasses.fields(GPT2Config)}
    fields -= {"attn_impl", "dtype"}
    return GPT2Config(**{k: v for k, v in blob.items() if k in fields})


_BLOCK_LEAVES = (
    # (HF key under transformer.h.{i}., flax path in the block)
    ("ln_1.weight", ("ln_1", "scale")), ("ln_1.bias", ("ln_1", "bias")),
    ("attn.c_attn.weight", ("attn", "c_attn", "kernel")),
    ("attn.c_attn.bias", ("attn", "c_attn", "bias")),
    ("attn.c_proj.weight", ("attn", "c_proj", "kernel")),
    ("attn.c_proj.bias", ("attn", "c_proj", "bias")),
    ("ln_2.weight", ("ln_2", "scale")), ("ln_2.bias", ("ln_2", "bias")),
    ("mlp.c_fc.weight", ("mlp", "c_fc", "kernel")),
    ("mlp.c_fc.bias", ("mlp", "c_fc", "bias")),
    ("mlp.c_proj.weight", ("mlp", "c_proj", "kernel")),
    ("mlp.c_proj.bias", ("mlp", "c_proj", "bias")),
)


def _get(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _put(tree, path, val):
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = val


def convert_torch_gpt2(state_dict, cfg: GPT2Config) -> dict:
    """A ``transformers`` GPT-2 state dict (numpy arrays) -> the flax
    parameter tree (reference ``convert_torch_gpt2``, gpt2.py:399-453).
    Keys with or without the ``transformer.`` prefix; Conv1D kernels
    are (in, out) as the model's, so no transpose; ``wte`` grows to
    ``cfg.vocab_size`` with rows equal to the mean of its rows (the new
    special tokens); ``mc_head`` is drawn from
    ``np.random.RandomState(0)``; keys the model does not use (the
    ``attn.bias`` / ``attn.masked_bias`` buffers, ``lm_head``) are
    ignored."""

    def a(name):
        if name in state_dict:
            return np.asarray(state_dict[name])
        return np.asarray(state_dict[name.removeprefix("transformer.")])

    t = {}
    wte = a("transformer.wte.weight")
    if wte.shape[0] < cfg.vocab_size:
        extra = np.tile(wte.mean(0, keepdims=True),
                        (cfg.vocab_size - wte.shape[0], 1))
        wte = np.concatenate([wte, extra], 0)
    t["wte"] = wte
    t["wpe"] = a("transformer.wpe.weight")
    for i in range(cfg.n_layer):
        block = {}
        for hf, path in _BLOCK_LEAVES:
            _put(block, path, a(f"transformer.h.{i}.{hf}"))
        t[f"h_{i}"] = block
    t["ln_f"] = {"scale": a("transformer.ln_f.weight"),
                 "bias": a("transformer.ln_f.bias")}
    rng = np.random.RandomState(0)
    mc_head = {"kernel": rng.normal(0, cfg.initializer_range,
                                    (cfg.n_embd, 1)).astype(np.float32),
               "bias": np.zeros((1,), np.float32)}
    return {"transformer": t, "mc_head": mc_head}


def convert_gpt2_to_hf(params: dict, cfg: GPT2Config):
    """The flax parameter tree -> (a ``transformers``
    GPT2DoubleHeadsModel state dict of numpy arrays, its HF config
    dict) (reference ``convert_gpt2_to_hf``, gpt2.py:327-397): LayerNorm
    ``weight`` is flax's ``scale``, Conv1D kernels stay (in, out), the
    MC head is a torch Linear (out, in), so transposed, and
    ``lm_head.weight`` is the tied ``wte``."""
    t = params["transformer"]
    sd = {"transformer.wte.weight": np.asarray(t["wte"]),
          "transformer.wpe.weight": np.asarray(t["wpe"]),
          "transformer.ln_f.weight": np.asarray(t["ln_f"]["scale"]),
          "transformer.ln_f.bias": np.asarray(t["ln_f"]["bias"]),
          "lm_head.weight": np.asarray(t["wte"])}
    for i in range(cfg.n_layer):
        for hf, path in _BLOCK_LEAVES:
            sd[f"transformer.h.{i}.{hf}"] = np.asarray(
                _get(t[f"h_{i}"], path))
    if "mc_head" in params:
        sd["multiple_choice_head.summary.weight"] = \
            np.asarray(params["mc_head"]["kernel"]).T
        sd["multiple_choice_head.summary.bias"] = \
            np.asarray(params["mc_head"]["bias"])
    # the HF extras make the directory load with transformers'
    # from_pretrained; num_labels 1 gives the summary head its
    # (1, n_embd) projection
    hf_config = {
        "model_type": "gpt2",
        "architectures": ["GPT2DoubleHeadsModel"],
        "vocab_size": cfg.vocab_size,
        "n_positions": cfg.n_positions,
        "n_ctx": cfg.n_positions,
        "n_embd": cfg.n_embd,
        "n_layer": cfg.n_layer,
        "n_head": cfg.n_head,
        "layer_norm_epsilon": cfg.layer_norm_epsilon,
        "initializer_range": cfg.initializer_range,
        "activation_function": "gelu_new",
        "summary_type": "cls_index",
        "summary_use_proj": True,
        "summary_proj_to_labels": True,
        "summary_first_dropout": 0.0,
        "num_labels": 1,
    }
    return sd, hf_config
