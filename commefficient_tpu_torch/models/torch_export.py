"""Torch-format ``state_dict`` export for the CV model families.

Port of ``commefficient_tpu/models/torch_export.py`` (``_TRANSFORMS``
:36, ``_leaf`` :48, ``_walk`` :67, ``supports_torch_export`` :163,
``build_name_map`` :169, ``cv_state_dict`` :284, ``cv_load_state_dict``
:326). The port's models hold a flat vector; the source here is the
flax parameter tree their leaf specs describe
(``FlatModel.to_params_tree``), and their running statistics, which
``FedModel.model_state`` keeps as {leaf path: tensor}, are nested by
``nest_state``. The mapping reads only the tree and the model's
geometry attributes (``stage_sizes``, ``num_blocks``, ``layers``,
``block``, ``norm``), so the names are the reference's for the same
model.

The original CV artifact is ``torch.save(model.state_dict(),
checkpoint_path + model + '.pt')`` (reference cv_train.py:420-423),
with the key names of its torch modules (models/resnet9.py,
fixup_resnet9.py, fixup_resnet18.py, resnets.py). This module maps
each flax model family onto exactly those names so the saved file is
consumable by the torch ecosystem the reference lives in:

- conv kernels  (kh, kw, cin, cout) -> (cout, cin, kh, kw)
- dense kernels (in, out)           -> (out, in)
- LayerNorm over (H, W, C)          -> torch ``LayerNorm((C, h, w))``
  affine layout (C, h, w)
- BatchStatNorm scale/bias          -> ``bn.weight``/``bn.bias``, with
  the server's running stats (``batch_stats`` collection) as
  ``bn.running_mean``/``bn.running_var`` (+ ``num_batches_tracked``,
  torch's bookkeeping scalar)
- fixup scalars keep their reference names (``bias1a`` ...); the
  ResNet18 family wraps them in ``Add``/``Mul`` submodules, so they
  export as ``addXx.bias`` / ``mul.scale`` (reference
  fixup_resnet18.py:8-21)

The same name map drives the inverse (``cv_load_state_dict``), which
proves the export lossless.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

__all__ = ["cv_state_dict", "cv_load_state_dict", "build_name_map",
           "supports_torch_export", "save_torch_state_dict", "nest_state"]

# leaf-tensor layout transforms, keyed by tag; (export, import) pairs
_TRANSFORMS = {
    "conv": (lambda a: np.transpose(a, (3, 2, 0, 1)),
             lambda a: np.transpose(a, (2, 3, 1, 0))),
    "dense": (lambda a: np.transpose(a),
              lambda a: np.transpose(a)),
    "ln": (lambda a: np.transpose(a, (2, 0, 1)),
           lambda a: np.transpose(a, (1, 2, 0))),
    "id": (lambda a: a, lambda a: a),
}


def _leaf(torch_prefix: str, seg: str, leaf: str):
    """(torch_name, transform_tag) for one flax leaf under a module
    segment like Conv_0 / Dense_0 / BatchStatNorm_0 / LayerNorm_0."""
    if seg.startswith("Conv_"):
        assert leaf == "kernel", leaf
        return f"{torch_prefix}.weight", "conv"
    if seg.startswith("Dense_"):
        return (f"{torch_prefix}.weight", "dense") \
            if leaf == "kernel" else (f"{torch_prefix}.bias", "id")
    if seg.startswith("BatchStatNorm_"):
        name = {"scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}[leaf]
        return f"{torch_prefix}.{name}", "id"
    if seg.startswith("LayerNorm_"):
        name = {"scale": "weight", "bias": "bias"}[leaf]
        return f"{torch_prefix}.{name}", "ln"
    raise KeyError(f"unmapped module segment {seg!r}")


def _walk(tree, rename: Dict[str, Any], prefix: str, out, path=()):
    """Recursive renamer: ``rename`` maps flax child segment ->
    (torch segment, child rename map | None). A None child map means
    the segment is a primitive flax module handled by ``_leaf``;
    scalar fixup params appear as direct leaves and pass through a
    '' mapping or their own (name, "leaf") entries."""
    for seg, sub in tree.items():
        if not isinstance(sub, dict):
            # scalar fixup param leaf at this level (renamed when the
            # reference wraps it in an Add/Mul submodule)
            t = rename[seg][0] if seg in rename else seg
            tname = f"{prefix}.{t}" if prefix else t
            out[tname] = (path + (seg,), "id")
            continue
        if seg not in rename:
            raise KeyError(f"unmapped segment {seg!r} under "
                           f"{prefix or '<root>'!r}")
        tseg, child = rename[seg]
        tprefix = f"{prefix}.{tseg}" if prefix else tseg
        if child is None:
            for leaf in sub:
                tname, tag = _leaf(tprefix, seg, leaf)
                out[tname] = (path + (seg, leaf), tag)
        else:
            _walk(sub, child, tprefix, out, path + (seg,))


# --- family rename tables (reference module attribute names) ---------

_CONVBN = {"Conv_0": ("conv", None), "BatchStatNorm_0": ("bn", None)}
_RESIDUAL9 = {"ConvBN_0": ("res1", _CONVBN),
              "ConvBN_1": ("res2", _CONVBN)}
# reference resnet9.py:74-124: the net lives under the ``n`` attribute
_RESNET9 = {
    "ConvBN_0": ("n.prep", _CONVBN),
    "ConvBN_1": ("n.layer1", _CONVBN),
    "Residual_0": ("n.res1", _RESIDUAL9),
    "ConvBN_2": ("n.layer2", _CONVBN),
    "ConvBN_3": ("n.layer3", _CONVBN),
    "Residual_1": ("n.res3", _RESIDUAL9),
    "Dense_0": ("n.linear", None),
}

# reference fixup_resnet9.py:10-56 (+ the fixup submodule's cifar
# FixupBasicBlock naming: conv1/conv2 + bias/scale scalars)
_FIXUP_BLOCK9 = {"Conv_0": ("conv1", None), "Conv_1": ("conv2", None)}
_FIXUP_LAYER9 = {"Conv_0": ("conv", None)}
for _i in range(4):
    _FIXUP_LAYER9[f"FixupBasicBlock_{_i}"] = (f"blocks.{_i}",
                                              _FIXUP_BLOCK9)
_FIXUPRESNET9 = {
    "Conv_0": ("conv1", None),
    "FixupLayer_0": ("layer1", _FIXUP_LAYER9),
    "FixupLayer_1": ("layer2", _FIXUP_LAYER9),
    "FixupLayer_2": ("layer3", _FIXUP_LAYER9),
    "Dense_0": ("linear", None),
}

# reference fixup_resnet18.py:24-63, 66-133: a flat ``layers``
# Sequential over all blocks; scalars live in Add/Mul submodules.
# FixupBlock's map is built per block in build_name_map — flax creates
# the shortcut conv BEFORE conv1 when present (models/resnet18.py:
# 67-69), so the Conv_i labels shift per block.

_PREACT_BLOCK = {"Conv_0": ("conv1", None),
                 "BatchStatNorm_0": ("bn1", None),
                 "Conv_1": ("conv2", None),
                 "BatchStatNorm_1": ("bn2", None),
                 "Conv_2": ("shortcut.0", None)}

# reference resnets.py (torchvision fork) block naming
_BASIC_BLOCK = {"Conv_0": ("conv1", None), "Conv_1": ("conv2", None),
                "Conv_2": ("downsample.0", None)}
_BOTTLENECK = {"Conv_0": ("conv1", None), "Conv_1": ("conv2", None),
               "Conv_2": ("conv3", None),
               "Conv_3": ("downsample.0", None)}


def _with_norms(base: Dict, n_norms: int, norm_seg: str,
                names) -> Dict:
    d = dict(base)
    for i in range(n_norms):
        d[f"{norm_seg}_{i}"] = (names[i], None)
    return d


def _stage_layout(stage_sizes) -> Dict[int, str]:
    """Flat block index -> ``layer{stage}.{i}`` (torch Sequential)."""
    out, idx = {}, 0
    for s, n in enumerate(stage_sizes):
        for b in range(n):
            out[idx] = f"layer{s + 1}.{b}"
            idx += 1
    return out


def supports_torch_export(module) -> bool:
    return type(module).__name__ in ("ResNet9", "FixupResNet9",
                                     "FixupResNet50", "ResNet18",
                                     "FixupResNet18", "ResNet")


def build_name_map(module, params,
                   model_state: Optional[dict] = None
                   ) -> Dict[str, Tuple[Tuple[str, ...], str, str]]:
    """torch_name -> (flax_path, transform_tag, collection). The map
    is derived from the actual param tree (block/downsample presence
    varies with geometry), so it is exact for the instance exported."""
    fam = type(module).__name__
    out: Dict[str, Tuple[Tuple[str, ...], str]] = {}

    def walk(rename):
        _walk(params, rename, "", out)

    if fam == "ResNet9":
        walk(_RESNET9)
    elif fam == "FixupResNet9":
        walk(_FIXUPRESNET9)
    elif fam == "FixupResNet50":
        layout = _stage_layout(module.stage_sizes)
        fb = {"Conv_0": ("conv1", None), "Conv_1": ("conv2", None),
              "Conv_2": ("conv3", None), "Conv_3": ("downsample", None)}
        rename = {"Conv_0": ("conv1", None), "Dense_0": ("fc", None)}
        for i, tseg in layout.items():
            rename[f"FixupBottleneck_{i}"] = (tseg, fb)
        walk(rename)
    elif fam in ("ResNet18", "FixupResNet18"):
        n_blocks = sum(module.num_blocks)
        rename = {"Conv_0": ("prep" if fam == "FixupResNet18"
                             else "prep.0", None),
                  "Dense_0": ("classifier", None)}
        for i in range(n_blocks):
            if fam == "ResNet18":
                rename[f"PreActBlock_{i}"] = (f"layers.{i}",
                                              _PREACT_BLOCK)
            else:
                # flax created the shortcut conv FIRST when present
                # (models/resnet18.py:67-75): relabel per block
                blk = params.get(f"FixupBlock_{i}", {})
                has_sc = "Conv_2" in blk
                m = {("Conv_0" if not has_sc else "Conv_1"):
                     ("conv1", None),
                     ("Conv_1" if not has_sc else "Conv_2"):
                     ("conv2", None)}
                if has_sc:
                    m["Conv_0"] = ("shortcut", None)
                for s, t in (("add1a", "add1a.bias"),
                             ("add1b", "add1b.bias"),
                             ("add2a", "add2a.bias"),
                             ("add2b", "add2b.bias"),
                             ("mul", "mul.scale")):
                    m[s] = (t, "leaf")
                rename[f"FixupBlock_{i}"] = (f"layers.{i}", m)
        walk(rename)
    elif fam == "ResNet":
        layout = _stage_layout(module.layers)
        norm_seg = ("BatchStatNorm" if module.norm == "batch"
                    else "LayerNorm")
        rename = {"Conv_0": ("conv1", None),
                  f"{norm_seg}_0": ("bn1", None),
                  "Dense_0": ("fc", None)}
        from commefficient_tpu_torch.models.resnets import Bottleneck
        bottleneck = module.block is Bottleneck
        for i, tseg in layout.items():
            bseg = ("Bottleneck" if bottleneck else "BasicBlock") \
                + f"_{i}"
            blk = params.get(bseg, {})
            n_convs = sum(1 for s in blk if s.startswith("Conv_"))
            base = dict(_BOTTLENECK if bottleneck else _BASIC_BLOCK)
            norm_names = (["bn1", "bn2", "bn3", "downsample.1"]
                          if bottleneck
                          else ["bn1", "bn2", "downsample.1"])
            bmap = _with_norms(base, n_convs, norm_seg, norm_names)
            rename[bseg] = (tseg, bmap)
        walk(rename)
    else:
        raise ValueError(
            f"torch-format export is not defined for {fam}; "
            "families: ResNet9/Fixup*/ResNet18/ResNet (use "
            "hf_format for GPT-2)")

    full = {name: (path, tag, "params") for name, (path, tag)
            in out.items()}
    if model_state:
        stats: Dict[str, Tuple[Tuple[str, ...], str]] = {}
        # reuse the same rename walk on the batch_stats tree: its
        # paths are a sub-tree of the params paths (norm sites only)
        def visit(tree, path=()):
            for seg, sub in tree.items():
                if isinstance(sub, dict):
                    visit(sub, path + (seg,))
                else:
                    stats[path + (seg,)] = sub
        visit(model_state)
        # invert the params map at the norm-module level to place
        # running stats beside their scale/bias
        prefix_of = {}
        for name, (path, tag) in out.items():
            if path[-1] in ("scale", "bias") \
                    and path[-2].startswith("BatchStatNorm_"):
                prefix_of[path[:-1]] = name.rsplit(".", 1)[0]
        for spath in stats:
            mod_path, leaf = spath[:-1], spath[-1]
            if mod_path in prefix_of:
                tname = {"mean": "running_mean",
                         "var": "running_var"}[leaf]
                full[f"{prefix_of[mod_path]}.{tname}"] = (
                    spath, "id", "batch_stats")
    return full


def _get(tree, path):
    for seg in path:
        tree = tree[seg]
    return tree


def cv_state_dict(module, params,
                  model_state: Optional[dict] = None) -> Dict[str, Any]:
    """Flax params (+ optional running stats) -> reference-named torch
    ``state_dict`` of numpy arrays (callers torch.save after
    torch.from_numpy; kept numpy here so the mapping is testable
    without torch)."""
    nm = build_name_map(module, params, model_state)
    sd = {}
    bn_sites = {}  # torch prefix -> channel count
    for tname, (path, tag, coll) in nm.items():
        src = params if coll == "params" else model_state
        arr = _TRANSFORMS[tag][0](np.asarray(_get(src, path)))
        sd[tname] = arr
        if len(path) >= 2 and path[-1] == "scale" \
                and path[-2].startswith("BatchStatNorm_"):
            bn_sites[tname.rsplit(".", 1)[0]] = arr.shape[0]
    for p, c in bn_sites.items():
        # torch nn.BatchNorm2d always carries running buffers; a
        # batch-stats-only site (track_stats=False) exports identity
        # stats so the file strict-loads into the reference module
        sd.setdefault(f"{p}.running_mean", np.zeros((c,), np.float32))
        sd.setdefault(f"{p}.running_var", np.ones((c,), np.float32))
        sd[f"{p}.num_batches_tracked"] = np.asarray(0, np.int64)
    return sd


def nest_state(model_state: Optional[dict]) -> Optional[dict]:
    """Running statistics as ``FedModel.model_state`` keeps them,
    {leaf path tuple: tensor}, -> the nested ``batch_stats`` tree of
    numpy arrays; None or an empty dict gives None."""
    if not model_state:
        return None
    out: dict = {}
    for path, val in model_state.items():
        node = out
        for seg in path[:-1]:
            node = node.setdefault(seg, {})
        node[path[-1]] = _numpy(val)
    return out


def _numpy(x) -> np.ndarray:
    if hasattr(x, "detach"):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


def _numpy_tree(tree: dict) -> dict:
    return {k: _numpy_tree(v) if isinstance(v, dict) else _numpy(v)
            for k, v in tree.items()}


def save_torch_state_dict(module, params, model_state, path: str):
    """``torch.save`` the reference-named state_dict to ``path``: the
    one recipe behind ``FedModel.save_pretrained(torch_format=True)``
    and cv_train's ``--checkpoint`` artifact. ``params`` is the flax
    tree (``FlatModel.to_params_tree``), ``model_state`` the running
    statistics or None."""
    import torch

    sd = cv_state_dict(module, _numpy_tree(params), nest_state(model_state))
    torch.save({k: torch.from_numpy(np.array(v, copy=True))
                for k, v in sd.items()}, path)


def cv_load_state_dict(module, params, sd,
                       model_state: Optional[dict] = None):
    """Inverse mapping: a reference-named state_dict back into a flax
    params pytree (+ running stats if ``model_state`` given) — proves
    the export lossless and gives the reference's torch checkpoints a
    way IN, not just out."""
    nm = build_name_map(module, params, model_state)
    new_params = _numpy_tree(params)
    new_state = _numpy_tree(model_state) if model_state else None

    def set_(tree, path, val):
        for seg in path[:-1]:
            tree = tree[seg]
        old = tree[path[-1]]
        assert old.shape == val.shape, (path, old.shape, val.shape)
        tree[path[-1]] = val.astype(old.dtype)

    for tname, (path, tag, coll) in nm.items():
        arr = _TRANSFORMS[tag][1](np.asarray(sd[tname]))
        set_(new_params if coll == "params" else new_state, path, arr)
    return (new_params, new_state) if model_state else new_params
