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


def unravel(flat: torch.Tensor, shapes: dict) -> dict:
    """Flat vector -> nested dict of views in their flax layouts (no
    copy: autograd through the views lands in the flat gradient)."""
    out: Dict = {}
    offset = 0
    for path, shape in ravel_order(shapes):
        n = _numel(shape)
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = flat[offset:offset + n].view(*shape)
        offset += n
    assert offset == flat.numel(), (offset, flat.numel())
    return out


def flatten_params(params: dict, device="cpu") -> torch.Tensor:
    """Nested dict of arrays/tensors -> flat f32 vector (the
    counterpart of ``ravel_pytree``)."""
    parts = [torch.from_numpy(np.array(leaf, np.float32)).reshape(-1)
             if not isinstance(leaf, torch.Tensor)
             else leaf.detach().to("cpu", torch.float32).reshape(-1)
             for _, leaf in ravel_order(params)]
    return torch.cat(parts).to(device)

