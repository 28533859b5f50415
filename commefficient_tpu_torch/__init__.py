"""PyTorch/CUDA port of ``commefficient_tpu`` for NVIDIA Hopper.

The JAX package beside this one is the reference: this package keeps
its module layout and names (``ops/sketch.py`` ports ``ops/sketch.py``
and so on) so every counterpart is easy to find, and it imports
nothing of the JAX package. What is ported so far is one FetchSGD
round of ResNet9 and the trainer that drives it:

- ``ops/``: the rotation count sketch, the exact threshold select and
  the flat parameter vector; their hand-written Hopper kernels
  (``csrc/sketch.cu``, ``csrc/radix_select.cu``, ``csrc/take_mask.cu``)
  sit behind ``ops/sketch_kernels.py`` and ``ops/topk_kernels.py``;
- ``models/resnet9.py``, ``core/``, ``runtime/fed_model.py``,
  ``data/`` and ``train/cv_train.py``.

Entry points run on ``cuda`` unless the caller asks for the CPU
(``device="cpu"``, ``--device cpu``), where every kernel wrapper takes
its plain PyTorch version. See ``device.py``.
"""

from commefficient_tpu_torch.device import resolve_device  # noqa: F401
