"""Model registry (replaces timm's ``register_model``/``create_model``
used at ``vit/main.py:268-272``)."""
from __future__ import annotations

from typing import Any, Callable, Dict

_MODEL_REGISTRY: Dict[str, Callable[..., Any]] = {}


def register_model(fn: Callable[..., Any]) -> Callable[..., Any]:
    _MODEL_REGISTRY[fn.__name__] = fn
    return fn


def create_model(name: str, **kwargs: Any):
    if name not in _MODEL_REGISTRY:
        raise KeyError(
            f"unknown model {name!r}; available: {sorted(_MODEL_REGISTRY)}")
    return _MODEL_REGISTRY[name](**kwargs)
