"""Neural-network pieces of the port: the eager ``Layer`` API and its
layers (:mod:`.layer`), functionals, initializers, and the global-norm
gradient clip the eager optimizers take."""
from . import functional, initializer
from .clip import ClipGradByGlobalNorm
from .layer import (GELU, AdaptiveAvgPool2D, AvgPool2D, BatchNorm2D, Conv2D,
                    CrossEntropyLoss, Dropout, Embedding, Flatten, Layer,
                    LayerList, LayerNorm, Linear, MaxPool2D, Parameter, ReLU,
                    Sequential, Tanh)

__all__ = ["functional", "initializer", "ClipGradByGlobalNorm", "Layer",
           "Parameter", "Linear", "Flatten", "Embedding", "Dropout", "ReLU",
           "GELU", "Tanh", "Sequential", "LayerList", "Conv2D", "MaxPool2D",
           "AvgPool2D", "AdaptiveAvgPool2D", "BatchNorm2D", "LayerNorm",
           "CrossEntropyLoss"]
