"""Model zoo: the layout-built default model, the separable model and the
subclassing base."""

from .base import Model, ConvBlockModel, TorchModel
from .layout import make_layout_network, parse_layout, ACTIVATIONS
from .separable import SeparableModel

__all__ = ["Model", "ConvBlockModel", "TorchModel", "SeparableModel",
           "make_layout_network", "parse_layout", "ACTIVATIONS"]
