"""Loss criteria registry, counterpart of ``pydens_tpu/utils/criteria.py``.

A criterion is any ``fn(pred, target) -> scalar tensor``; string names and
``torch.nn`` criterion instances (matched by class name, as the reference
passes ``nn.MSELoss()``) resolve through this registry.
"""

import torch

__all__ = ["resolve_criterion", "mse_loss", "l1_loss", "huber_loss",
           "smooth_l1_loss"]


def mse_loss(pred, target):
    return torch.mean(torch.square(pred - target))


def l1_loss(pred, target):
    return torch.mean(torch.abs(pred - target))


def huber_loss(pred, target, delta=1.0):
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return torch.mean(0.5 * quad ** 2 + delta * (err - quad))


def smooth_l1_loss(pred, target, beta=1.0):
    err = torch.abs(pred - target)
    return torch.mean(torch.where(err < beta, 0.5 * err ** 2 / beta,
                                  err - 0.5 * beta))


_CRITERIA = {
    "mseloss": mse_loss,
    "mse": mse_loss,
    "l1loss": l1_loss,
    "l1": l1_loss,
    "mae": l1_loss,
    "huberloss": huber_loss,
    "huber": huber_loss,
    "smoothl1loss": smooth_l1_loss,
    "smoothl1": smooth_l1_loss,
}


def resolve_criterion(criterion):
    """Resolve a criterion spec (str | torch criterion instance | callable)
    to a callable and a cache key."""
    if isinstance(criterion, str):
        key = criterion.lower().replace("_", "")
        if key not in _CRITERIA:
            raise ValueError(f"unknown criterion {criterion!r}; "
                             f"known: {sorted(set(_CRITERIA))}")
        return _CRITERIA[key], key
    cls_name = type(criterion).__name__.lower()
    mod = type(criterion).__module__ or ""
    if mod.startswith("torch") and cls_name in _CRITERIA:
        return _CRITERIA[cls_name], cls_name
    if callable(criterion):
        return criterion, id(criterion)
    raise ValueError(f"cannot interpret criterion {criterion!r}")
