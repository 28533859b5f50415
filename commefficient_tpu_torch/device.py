"""Device resolution and the port's precision settings.

Entry points take an explicit ``device``; ``"cuda"`` is the default
everywhere and there is no quiet fallback: asking for the card where
there is none raises. ``"cpu"`` is the tests' device, on which every
kernel wrapper runs its plain PyTorch version.

Precision, stated once: float32 matrix products and float32
convolutions run in full float32 on the card. PyTorch leaves cuDNN
convolutions in TF32 by default (about three decimal digits), which
would put the port's f32 path far outside the reference's numerics;
both switches are set explicitly here. ``--bf16`` computes in
bfloat16 over float32 parameters regardless.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def configure_precision() -> None:
    """Full-float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` (str or torch.device) -> torch.device. ``cuda``
    without a visible card raises instead of running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch sees no CUDA "
                "device; pass device='cpu' (--device cpu) to run the "
                "plain PyTorch path on the CPU")
        configure_precision()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
