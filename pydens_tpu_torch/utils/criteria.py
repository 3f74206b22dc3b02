"""Loss criteria registry, counterpart of ``pydens_tpu/utils/criteria.py``.

A criterion is any ``fn(pred, target) -> scalar tensor``; string names and
``torch.nn`` criterion instances (matched by class name, as the reference
passes ``nn.MSELoss()``) resolve through this registry.  The registry's
criteria are the mean of an elementwise loss, kept as ``fn.elementwise``:
an ensemble takes each member's mean over its own rows in one op
(:func:`member_losses`).
"""

import torch

__all__ = ["resolve_criterion", "member_losses", "mse_loss", "l1_loss",
           "huber_loss", "smooth_l1_loss"]


def _squared(pred, target):
    return torch.square(pred - target)


def _absolute(pred, target):
    return torch.abs(pred - target)


def _huber(pred, target, delta=1.0):
    err = torch.abs(pred - target)
    quad = torch.clamp(err, max=delta)
    return 0.5 * quad ** 2 + delta * (err - quad)


def _smooth_l1(pred, target, beta=1.0):
    err = torch.abs(pred - target)
    return torch.where(err < beta, 0.5 * err ** 2 / beta, err - 0.5 * beta)


def _mean_of(elementwise):
    def criterion(pred, target):
        return torch.mean(elementwise(pred, target))
    criterion.elementwise = elementwise
    return criterion


mse_loss = _mean_of(_squared)
l1_loss = _mean_of(_absolute)
huber_loss = _mean_of(_huber)
smooth_l1_loss = _mean_of(_smooth_l1)


def member_losses(criterion, pred, target, n_models):
    """Each ensemble member's own ``criterion`` over its rows of
    member-major ``pred`` (``(n_models * rows, ...)``), as ``(n_models,)``;
    ``target`` is per row or broadcasts.  A single model's is
    ``criterion(pred, target)``.  A registry criterion is one op over all
    members; any other callable runs member by member."""
    if n_models == 1:
        return criterion(pred, target)
    elementwise = getattr(criterion, "elementwise", None)
    if elementwise is not None:
        return elementwise(pred, target).reshape(n_models, -1).mean(1)
    preds = pred.reshape((n_models, -1) + tuple(pred.shape[1:]))
    per_row = target.dim() > 0 and target.shape[0] == pred.shape[0]
    targets = (target.reshape((n_models, -1) + tuple(target.shape[1:]))
               if per_row else [target] * n_models)
    return torch.stack([torch.as_tensor(criterion(p, t))
                        for p, t in zip(preds, targets)])


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
