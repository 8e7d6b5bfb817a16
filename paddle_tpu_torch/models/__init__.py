"""Model pieces of the port (counterpart of paddle_tpu/models)."""

from .resnet import resnet_cifar10, resnet_imagenet  # noqa: F401
