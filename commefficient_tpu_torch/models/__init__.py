"""Model registry (port of ``commefficient_tpu/models/__init__.py``).

Every model of the reference's registry is ported: ResNet9, the
Fixup ResNets (FixupResNet9, FixupResNet50, FixupResNet18), ResNet18,
the torchvision-style ResNet family with ResNet101LN, and
GPT2DoubleHeads. ``NOT_PORTED`` names what still waits, so that asking
for it raises ``NotImplementedError`` naming it (empty now).
"""

from __future__ import annotations

_REGISTRY = {}

# the reference's registered models that the port does not have yet
NOT_PORTED: tuple = ()


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def _ensure_loaded():
    from commefficient_tpu_torch.models import (  # noqa: F401
        fixup_resnet9, gpt2, resnet9, resnet18, resnets)


def get_model(name: str):
    _ensure_loaded()
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in NOT_PORTED:
        raise NotImplementedError(f"--model {name} is not ported")
    raise KeyError(name)


def model_names():
    _ensure_loaded()
    return sorted(set(_REGISTRY) | set(NOT_PORTED))
