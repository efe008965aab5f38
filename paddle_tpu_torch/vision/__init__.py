"""The vision package of paddle_tpu/vision that the port has: the ResNet
family and LeNet (`models`), and MNIST / FashionMNIST (`datasets`). The
other models, transforms and ops wait on ROADMAP queue A10b."""
from . import datasets, models
from .models import LeNet, ResNet, resnet18, resnet50

__all__ = ["LeNet", "ResNet", "datasets", "models", "resnet18", "resnet50"]
