"""Model pieces of the port (counterpart of paddle_tpu/models)."""

from .deepfm import deepfm  # noqa: F401
from .resnet import resnet_cifar10, resnet_imagenet  # noqa: F401
