"""PyTorch/CUDA port of ``commefficient_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: this package keeps
its module layout and names (``ops/sketch.py`` ports ``ops/sketch.py``
and so on) so every counterpart is easy to find, and it imports
nothing of the JAX package. What is ported so far: the FetchSGD round
and the reference's other modes, with the CV trainer and every CV model
of the reference's registry, and GPT-2 on PersonaChat:

- ``ops/``: the rotation count sketch, the exact threshold select, the
  quantized wire and the flat parameter vector; their hand-written
  Hopper kernels (``csrc/sketch.cu``, ``csrc/radix_select.cu``,
  ``csrc/take_mask.cu``, ``csrc/flce.cu``) sit behind
  ``ops/sketch_kernels.py``, ``ops/topk_kernels.py`` and
  ``ops/flce_kernels.py``;
- ``models/`` (ResNet9, the ResNet family with ResNet101LN, the Fixup
  ResNets, ResNet18, GPT-2), ``core/``, ``runtime/fed_model.py``,
  ``data/`` (CIFAR, FEMNIST, PersonaChat, Synthetic) and ``train/``;
- ``clientstore/`` (per-client state off the card), ``privacy/``,
  ``runtime/checkpoint.py`` and ``asyncfed/`` (buffered asynchronous
  rounds);
- ``serialization.py``: flax's msgpack format of a parameter tree, in
  which GPT-2's final model is saved and from which it reloads.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``), where every kernel wrapper takes
its plain PyTorch version. See ``device.py``.
"""

from commefficient_tpu_torch.device import resolve_device  # noqa: F401
