"""The paper's own model: Table-I ResNet-18 with cut layers on CIFAR-10/100
and STL-10 shapes (counterpart of ``repro/configs/resnet18_cifar.py``;
the datasets are the synthetic stand-ins of ``repro_torch.data``)."""
from __future__ import annotations

from repro_torch.config import HeteroProfile
from repro_torch.models.resnet import ResNetConfig

# the paper's heterogeneous setting: 12 clients, 4 each at cut layers 3/4/5
HETERO_SPLITS = (3,) * 4 + (4,) * 4 + (5,) * 4


def config(dataset: str = "cifar10", width_mult: float = 1.0) -> ResNetConfig:
    num_classes = {"cifar10": 10, "cifar100": 100, "stl10": 10}[dataset]
    stem_stride = 2 if dataset == "stl10" else 1
    image_size = 96 if dataset == "stl10" else 32
    return ResNetConfig(num_classes=num_classes, stem_stride=stem_stride,
                        width_mult=width_mult, image_size=image_size)


def smoke() -> ResNetConfig:
    return ResNetConfig(num_classes=10, width_mult=0.125, image_size=32)


def profile(homo_layer: int | None = None) -> HeteroProfile:
    if homo_layer is not None:
        return HeteroProfile(split_layers=(homo_layer,) * 12)
    return HeteroProfile(split_layers=HETERO_SPLITS)
