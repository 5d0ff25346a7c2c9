"""Minimal yacs-compatible config tree.

The reference framework drives everything off a yacs ``CfgNode`` singleton
(reference: config/defaults.py:8, config/__init__.py:1).  We keep the same
"config is a frozen attribute tree with YAML merge + dotted-list override"
contract without depending on yacs (not in the image).
"""

from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List

import yaml


class CfgNode(dict):
    """A dict with attribute access, freezing, YAML merge and CLI override."""

    IMMUTABLE = "__immutable__"

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode.IMMUTABLE, False)
        if init_dict:
            for k, v in init_dict.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        if name in self:
            return self[name]
        raise AttributeError(f"Config has no attribute {name!r}")

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode.IMMUTABLE):
            raise AttributeError(f"Config is frozen; cannot set {name!r}")
        self[name] = value

    # -- freezing ---------------------------------------------------------
    def freeze(self) -> None:
        self._set_immutable(True)

    def defrost(self) -> None:
        self._set_immutable(False)

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode.IMMUTABLE)

    def _set_immutable(self, value: bool) -> None:
        object.__setattr__(self, CfgNode.IMMUTABLE, value)
        for v in self.values():
            if isinstance(v, CfgNode):
                v._set_immutable(value)

    # -- merging ----------------------------------------------------------
    def clone(self) -> "CfgNode":
        node = CfgNode()
        for k, v in self.items():
            node[k] = v.clone() if isinstance(v, CfgNode) else copy.deepcopy(v)
        return node

    def merge_from_other(self, other: Dict[str, Any], _path: str = "") -> None:
        for k, v in other.items():
            full = f"{_path}.{k}" if _path else k
            if k not in self:
                raise KeyError(f"Unknown config key: {full}")
            if isinstance(self[k], CfgNode):
                if not isinstance(v, dict):
                    raise TypeError(f"Cannot override config group {full} with a leaf value")
                self[k].merge_from_other(v, full)
            else:
                self[k] = _coerce(_maybe_literal_eval(v), self[k], full)

    def merge_from_file(self, path: str) -> None:
        with open(path, "r") as f:
            data = yaml.safe_load(f) or {}
        self.merge_from_other(data)

    def merge_from_list(self, opts: List[Any]) -> None:
        if len(opts) % 2 != 0:
            raise ValueError("Override list must have even length (KEY VALUE ...)")
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    raise KeyError(f"Unknown config key: {key} (no group {p!r})")
                node = node[p]
                if not isinstance(node, CfgNode):
                    raise KeyError(f"{key}: {p} is not a config group")
            leaf = parts[-1]
            if leaf not in node:
                raise KeyError(f"Unknown config key: {key}")
            if isinstance(value, str):
                try:
                    value = yaml.safe_load(value)
                except yaml.YAMLError:
                    pass
            value = _maybe_literal_eval(value)
            node[leaf] = _coerce(value, node[leaf], key)

    def dump(self) -> str:
        return yaml.safe_dump(_to_plain(self), sort_keys=False)


def _to_plain(node: Any) -> Any:
    if isinstance(node, CfgNode):
        return {k: _to_plain(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_plain(v) for v in node]
    return node


def _maybe_literal_eval(value: Any) -> Any:
    """yacs literal_evals every string config value (_decode_cfg_value), so
    python-literal syntax like ("Car", "Cyclist") or (2400, 2900) parses to
    a tuple whether it came from a yaml file or the command line."""
    if isinstance(value, str):
        try:
            return ast.literal_eval(value)
        except (ValueError, SyntaxError):
            pass
    return value


def _coerce(value: Any, old: Any, key: str) -> Any:
    """Mimic yacs type checking: keep tuple-ness, allow int->float."""
    if isinstance(old, tuple) and isinstance(value, list):
        value = tuple(tuple(v) if isinstance(v, list) else v for v in value)
    if isinstance(old, float) and isinstance(value, int):
        value = float(value)
    if old is not None and value is not None:
        if isinstance(old, bool) != isinstance(value, bool) and (
            isinstance(old, bool) or isinstance(value, bool)
        ):
            raise TypeError(f"Type mismatch for {key}: bool vs {type(value).__name__}")
    return value
