"""Model zoo: the layout-built default model and the subclassing base."""

from .base import Model, ConvBlockModel, TorchModel
from .layout import make_layout_network, parse_layout, ACTIVATIONS

__all__ = ["Model", "ConvBlockModel", "TorchModel", "make_layout_network",
           "parse_layout", "ACTIVATIONS"]
