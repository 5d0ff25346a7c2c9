"""Decorator registry (a copy of the JAX package's ``utils/registry.py``;
reference: utils/registry.py:9-46, model/registry.py:1-5)."""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry(dict):
    """dict with a register decorator: @REGISTRY.register("name")."""

    def register(self, name: str, obj: Any = None):
        if obj is not None:
            if name in self:
                raise KeyError(f"{name} already registered")
            self[name] = obj
            return obj

        def deco(fn_or_class):
            if name in self:
                raise KeyError(f"{name} already registered")
            self[name] = fn_or_class
            return fn_or_class

        return deco


BACKBONES = Registry()
PREDICTORS = Registry()
HEADS = Registry()
