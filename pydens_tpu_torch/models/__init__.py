"""Model zoo: the layout-built default model, the separable model, the
``nn.Module`` adapter and the subclassing base."""

from .base import Model, ConvBlockModel, TorchModel
from .module_adapter import ModuleModel, module_model
from .layout import make_layout_network, parse_layout, ACTIVATIONS
from .separable import SeparableModel

__all__ = ["Model", "ConvBlockModel", "TorchModel", "ModuleModel",
           "module_model", "SeparableModel",
           "make_layout_network", "parse_layout", "ACTIVATIONS"]
