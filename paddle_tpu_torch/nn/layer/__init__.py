"""The eager layers of the port (``paddle_tpu/nn/layer``)."""
from .activation import ReLU
from .common import Flatten, Linear
from .container import Sequential
from .conv import Conv2D
from .layers import Layer, Parameter
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["Layer", "Parameter", "Linear", "Flatten", "ReLU", "Sequential",
           "Conv2D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "BatchNorm2D", "CrossEntropyLoss"]
