from commefficient_tpu_torch.runtime.fed_model import (  # noqa: F401
    FedModel, FedOptimizer, LambdaLR, drain_rounds)
