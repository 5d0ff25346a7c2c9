"""Head-topology-as-data: map regression head keys to channel slices.

The reg tower emits one (B, H, W, C_total) tensor; this maps a key like
"corner_offset" to its channel slice (reference: model/layers/utils.py:22-37).
"""

from typing import List, Sequence


class Key2Channel:
    def __init__(self, keys: Sequence[Sequence[str]], channels: Sequence[Sequence[int]]):
        self.keys: List[str] = [k for group in keys for k in group]
        self.channels: List[int] = [c for group in channels for c in group]
        if len(self.keys) != len(self.channels):
            raise ValueError("REGRESSION_HEADS and REGRESSION_CHANNELS mismatch")

    def __contains__(self, key: str) -> bool:
        return key in self.keys

    def __call__(self, key: str) -> slice:
        index = self.keys.index(key)
        s = sum(self.channels[:index])
        return slice(s, s + self.channels[index])

    @property
    def total_channels(self) -> int:
        return sum(self.channels)
