"""Per-image target container (a copy of the JAX package's
``structures/params_3d.py``; reference: structures/params_3d.py:5-56).

The port's pipeline moves plain dict batches; this container keeps API
parity for code written against the reference (field get/set)."""

from __future__ import annotations

from typing import Any, Dict, Tuple


class ParamsList:
    def __init__(self, image_size: Tuple[int, int], is_train: bool = True):
        self.size = image_size
        self.is_train = is_train
        self.extra_fields: Dict[str, Any] = {}

    def add_field(self, field: str, data: Any) -> None:
        self.extra_fields[field] = data

    def get_field(self, field: str) -> Any:
        return self.extra_fields[field]

    def has_field(self, field: str) -> bool:
        return field in self.extra_fields

    def fields(self):
        return list(self.extra_fields.keys())

    def to_dict(self) -> Dict[str, Any]:
        return dict(self.extra_fields)

    def __len__(self) -> int:
        return len(self.extra_fields)

    def __repr__(self) -> str:
        return f"ParamsList(size={self.size}, fields={self.fields()})"
