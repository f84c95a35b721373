"""Model zoo (the port's counterpart of paddle_tpu/models): the reference's
benchmark and book models, built on the layers DSL."""

from .alexnet import alexnet
from .googlenet import googlenet
from .mnist import mnist_conv, mnist_mlp
from .resnet import resnet_cifar10, resnet_imagenet, resnet50
from .smallnet import smallnet_mnist_cifar
from .common import build_image_classifier
from .transformer import transformer_lm
from .vgg import vgg16, vgg19

__all__ = ["alexnet", "googlenet", "mnist_conv", "mnist_mlp",
           "resnet_cifar10", "resnet_imagenet", "resnet50",
           "smallnet_mnist_cifar", "build_image_classifier", "transformer_lm",
           "vgg16", "vgg19"]
