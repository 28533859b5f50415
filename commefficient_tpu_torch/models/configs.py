"""Per-model training configs (port of
``commefficient_tpu/models/configs.py``).

``ModelConfig.set_args(args, parser_defaults)`` overlays recommended
hyperparameters onto a parsed Config, only for fields still at their
parser defaults (explicit flags win). ``lr_schedule_shape`` (where a
config defines one) replaces the default triangular schedule in
cv_train: the LR is ``args.lr_scale * shape(epoch)``.
"""

from __future__ import annotations

from typing import Optional

from commefficient_tpu_torch.utils import PiecewiseLinear


class ModelConfig:
    #: fields overlaid onto args (name -> value)
    overrides: dict = {}
    #: epoch -> multiplier with peak 1.0; None keeps the triangular
    #: default schedule
    lr_schedule_shape: Optional[PiecewiseLinear] = None

    def set_args(self, args, parser_defaults: dict):
        """Overlay the recommended values onto fields still at their
        parser defaults (argparse cannot tell an omitted flag from one
        passed at its default: those are overlaid too)."""
        applied = {}
        for name, val in self.overrides.items():
            if getattr(args, name) == parser_defaults.get(name, object()):
                setattr(args, name, val)
                applied[name] = val
        return applied


class FixupResNet50Config(ModelConfig):
    """ImageNet FixupResNet50 step schedule: peak lr_scale 0.1 decayed
    10x at epochs 30/60/90."""
    overrides = {"lr_scale": 0.1, "weight_decay": 1e-4, "num_epochs": 100.0}
    lr_schedule_shape = PiecewiseLinear(
        [0, 30, 30, 60, 60, 90, 90, 100],
        [1.0, 1.0, 0.1, 0.1, 0.01, 0.01, 0.001, 0.001])


MODEL_CONFIGS = {
    "FixupResNet50": FixupResNet50Config,
}


def get_model_config(model_name: str) -> Optional[ModelConfig]:
    cls = MODEL_CONFIGS.get(model_name)
    return cls() if cls is not None else None
