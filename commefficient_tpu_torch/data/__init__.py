from commefficient_tpu_torch.data.fed_dataset import FedDataset  # noqa: F401
from commefficient_tpu_torch.data.fed_sampler import FedSampler  # noqa: F401
from commefficient_tpu_torch.data.loader import FedLoader, ValLoader  # noqa: F401
from commefficient_tpu_torch.data.synthetic import FedSynthetic  # noqa: F401

DATASET_REGISTRY = {"Synthetic": FedSynthetic}


def get_dataset_cls(name: str):
    """Dataset registry; the reference's on-disk datasets (CIFAR,
    EMNIST, ImageNet, PERSONA) are not ported yet."""
    if name not in DATASET_REGISTRY:
        raise NotImplementedError(f"--dataset_name {name} is not ported")
    return DATASET_REGISTRY[name]
