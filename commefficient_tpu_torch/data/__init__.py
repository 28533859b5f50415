from commefficient_tpu_torch.data.fed_cifar import (  # noqa: F401
    FedCIFAR10, FedCIFAR100)
from commefficient_tpu_torch.data.fed_dataset import FedDataset  # noqa: F401
from commefficient_tpu_torch.data.fed_emnist import FedEMNIST  # noqa: F401
from commefficient_tpu_torch.data.fed_imagenet import FedImageNet  # noqa: F401
from commefficient_tpu_torch.data.fed_persona import FedPERSONA  # noqa: F401
from commefficient_tpu_torch.data.fed_sampler import FedSampler  # noqa: F401
from commefficient_tpu_torch.data.loader import (  # noqa: F401
    FedLoader, PersonaFedLoader, PersonaValLoader, ValLoader)
from commefficient_tpu_torch.data.synthetic import FedSynthetic  # noqa: F401

DATASET_REGISTRY = {"Synthetic": FedSynthetic, "PERSONA": FedPERSONA,
                    "CIFAR10": FedCIFAR10, "CIFAR100": FedCIFAR100,
                    "EMNIST": FedEMNIST, "ImageNet": FedImageNet}


def get_dataset_cls(name: str):
    """Dataset registry: every dataset of the reference trainers."""
    if name not in DATASET_REGISTRY:
        raise NotImplementedError(f"--dataset_name {name} is not ported")
    return DATASET_REGISTRY[name]
