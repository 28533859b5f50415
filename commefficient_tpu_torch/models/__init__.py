"""Model registry (port of ``commefficient_tpu/models/__init__.py``).

ResNet9 and GPT2DoubleHeads are ported; the reference's other model
names are known so that asking for one raises ``NotImplementedError``
naming it.
"""

from __future__ import annotations

_REGISTRY = {}

# the reference's registered models that the port does not have yet
NOT_PORTED = ("FixupResNet9", "FixupResNet50", "ResNet18",
              "FixupResNet18", "ResNet101LN",
              "resnet18", "resnet34", "resnet50", "resnet101",
              "resnet152", "resnext50_32x4d", "resnext101_32x8d",
              "wide_resnet50_2", "wide_resnet101_2")


def register_model(name: str):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def _ensure_loaded():
    from commefficient_tpu_torch.models import gpt2, resnet9  # noqa: F401


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
