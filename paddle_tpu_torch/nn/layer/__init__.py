"""The eager layers of the port (``paddle_tpu/nn/layer``)."""
from .activation import GELU, ReLU, Tanh
from .common import Dropout, Embedding, Flatten, Linear
from .container import LayerList, Sequential
from .conv import Conv2D
from .layers import Layer, Parameter
from .loss import CrossEntropyLoss
from .norm import BatchNorm2D, LayerNorm
from .pooling import AdaptiveAvgPool2D, AvgPool2D, MaxPool2D

__all__ = ["Layer", "Parameter", "Linear", "Flatten", "Embedding",
           "Dropout", "ReLU", "GELU", "Tanh", "Sequential", "LayerList",
           "Conv2D", "MaxPool2D", "AvgPool2D", "AdaptiveAvgPool2D",
           "BatchNorm2D", "LayerNorm", "CrossEntropyLoss"]
