from commefficient_tpu_torch.ops.sketch import CountSketch  # noqa: F401
