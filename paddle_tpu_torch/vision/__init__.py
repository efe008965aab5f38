"""The vision models of paddle_tpu/vision that the port has: the ResNet
family (`models.resnet`). The others wait on ROADMAP queue A10."""
from . import models
from .models import ResNet, resnet18, resnet50

__all__ = ["ResNet", "models", "resnet18", "resnet50"]
