"""Flat parameter-vector utilities.

Port of ``commefficient_tpu/ops/vec.py``. The whole model is one flat
f32 vector, in exactly the order and layout of JAX's ``ravel_pytree``
of the flax parameter tree: nested dict keys sorted at every level,
each leaf raveled in C order in its flax layout (HWIO conv kernels,
(in, out) dense kernels). The sketch hashes coordinate indices, so any
other order would put the same gradient into other buckets.

A parameter tree here is a nested dict whose leaves are shapes (the
model's ``leaf_shapes()``), numpy arrays or tensors.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

Path = Tuple[str, ...]


def ravel_order(tree: dict, prefix: Path = ()) -> List[Tuple[Path, object]]:
    """(path, leaf) pairs in ``ravel_pytree`` order: sorted keys,
    depth first."""
    out = []
    for key in sorted(tree):
        sub = tree[key]
        if isinstance(sub, dict):
            out.extend(ravel_order(sub, prefix + (key,)))
        else:
            out.append((prefix + (key,), sub))
    return out


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def flat_size(shapes: dict) -> int:
    return sum(_numel(s) for _, s in ravel_order(shapes))


class _Unravel(torch.autograd.Function):
    """All leaf views of the flat vector at once. The backward
    concatenates the leaves' gradients into ONE flat gradient; slicing
    leaf by leaf would have autograd build a zero-filled flat-sized
    tensor per leaf (some 150 of 124M floats each for GPT-2). The
    separate ``setup_context`` and the generated vmap rule let
    ``torch.func.grad`` and ``vmap`` run through it (the batched
    per-client pass, core/grad.py)."""

    generate_vmap_rule = True

    @staticmethod
    def forward(flat, shapes):
        return _views(flat, shapes)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.shapes = inputs[1]

    @staticmethod
    def backward(ctx, *grads):
        parts = [torch.zeros(_numel(s), dtype=torch.float32,
                             device=_device_of(grads)) if g is None
                 else g.reshape(-1) for g, s in zip(grads, ctx.shapes)]
        return torch.cat(parts), None


def _views(flat, shapes):
    out, offset = [], 0
    for shape in shapes:
        n = _numel(shape)
        out.append(flat[offset:offset + n].view(*shape))
        offset += n
    return tuple(out)


def _device_of(tensors):
    return next(t.device for t in tensors if t is not None)


def unravel(flat: torch.Tensor, shapes: dict) -> dict:
    """Flat vector -> nested dict of views in their flax layouts (no
    copy: autograd through the views lands in the flat gradient)."""
    order = ravel_order(shapes)
    assert flat.numel() == sum(_numel(s) for _, s in order), flat.numel()
    leaf_shapes = tuple(tuple(s) for _, s in order)
    if flat.requires_grad:
        leaves = _Unravel.apply(flat, leaf_shapes)
    else:
        leaves = _views(flat, leaf_shapes)
    out: Dict = {}
    for (path, _), leaf in zip(order, leaves):
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return out


def flatten_params(params: dict, device="cpu") -> torch.Tensor:
    """Nested dict of arrays/tensors -> flat f32 vector (the
    counterpart of ``ravel_pytree``)."""
    parts = [torch.from_numpy(np.array(leaf, np.float32)).reshape(-1)
             if not isinstance(leaf, torch.Tensor)
             else leaf.detach().to("cpu", torch.float32).reshape(-1)
             for _, leaf in ravel_order(params)]
    return torch.cat(parts).to(device)


def params_tree(flat: torch.Tensor, shapes: dict) -> dict:
    """Flat vector -> nested dict of numpy f32 arrays in their flax
    layouts, keys sorted at every level (the order
    ``jax.tree_util.tree_map`` leaves a flax tree in): the inverse of
    ``flatten_params``, one copy to the host."""
    host = flat.detach().to("cpu", torch.float32, copy=True)
    return _numpy_leaves(unravel(host, shapes))


def _numpy_leaves(tree: dict) -> dict:
    return {key: _numpy_leaves(sub) if isinstance(sub, dict)
            else sub.numpy() for key, sub in tree.items()}


def keystr(path: Path) -> str:
    """A leaf path as ``jax.tree_util.keystr`` prints a dict path:
    ``['FixupLayer_0']['bias1a']``."""
    return "".join(f"[{key!r}]" for key in path)


def param_group_indices(shapes: dict, *predicates) -> List[np.ndarray]:
    """Flat-vector index arrays grouping leaves by parameter-path name
    (reference ``param_group_indices``, ops/vec.py:31-60): each
    predicate receives the leaf's ``keystr`` path; a leaf joins the
    first predicate that matches, unmatched leaves a final catch-all
    group. Indices are positions in the flat vector (ravel order), so
    per-coordinate LRs built from them line up with the gradient."""
    spans: List[list] = [[] for _ in range(len(predicates) + 1)]
    offset = 0
    for path, shape in ravel_order(shapes):
        n = _numel(shape)
        name = keystr(path)
        group = next((i for i, pred in enumerate(predicates) if pred(name)),
                     len(predicates))
        spans[group].append((offset, n))
        offset += n
    return [np.concatenate([np.arange(o, o + n) for o, n in s])
            if s else np.empty(0, np.int64) for s in spans]


def global_norm(vec: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(vec * vec))


def clip_by_l2(vec: torch.Tensor, clip) -> torch.Tensor:
    """L2-clip to norm ``clip``, which may be a 0-dim tensor: only
    shrinks, never grows (reference ``clip_by_l2``, ops/vec.py:69)."""
    norm = global_norm(vec)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-12), max=1.0)
    return vec * scale


def packbits(mask: torch.Tensor) -> torch.Tensor:
    """(n,) bool -> (ceil(n/8),) uint8, big-endian bit order within a
    byte and the tail zero-padded: ``np.packbits`` and ``jnp.packbits``
    of the same mask. Runs on the tensor's device (the download
    support crosses to the host as this bitmap, 1/64 of int64 indices);
    ``np.unpackbits`` inverts it."""
    bits = mask.reshape(-1).to(torch.uint8)
    bits = torch.nn.functional.pad(bits, (0, (-bits.numel()) % 8))
    shifts = torch.arange(7, -1, -1, dtype=torch.uint8, device=mask.device)
    return torch.sum(bits.reshape(-1, 8) << shifts, dim=1,
                     dtype=torch.uint8)
