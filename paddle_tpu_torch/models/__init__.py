"""Model zoo, the part the ported slices use (the port's counterpart of
paddle_tpu/models)."""

from .mnist import mnist_conv, mnist_mlp
from .resnet import resnet_cifar10, resnet_imagenet, resnet50
from .common import build_image_classifier
from .transformer import transformer_lm
from .vgg import vgg16, vgg19

__all__ = ["mnist_conv", "mnist_mlp", "resnet_cifar10", "resnet_imagenet",
           "resnet50", "build_image_classifier", "transformer_lm", "vgg16",
           "vgg19"]
