"""``weight_attr`` / ``bias_attr`` for the port's own layers (the
reference's ``Layer.create_parameter``, paddle_tpu/nn/layer/layers.py).

``ParamAttr`` is not ported (ROADMAP queue A3): a layer takes ``None``
(a parameter) or ``False`` (none) for its ``weight_attr`` /
``bias_attr``.
"""
from __future__ import annotations

__all__ = ["wants_parameter"]


def wants_parameter(attr, what) -> bool:
    """``weight_attr`` / ``bias_attr``: None makes the parameter, False
    leaves it out."""
    if attr is None:
        return True
    if attr is False:
        return False
    raise NotImplementedError(
        f"{what}={attr!r}: ParamAttr and initializers are not ported yet "
        f"(ROADMAP queue A3); pass None or False")
