"""BiMap: immutable bidirectional map, ubiquitous in templates for
string-id ↔ dense-index translation (reference: [U] data/.../storage/
BiMap.scala with its stringInt/stringLong factories — unverified).

The dense index side is what matters on the device: ``string_int``
assigns contiguous int32 indices so entity ids can address rows of
factor matrices / embedding tables directly.
"""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterable, Iterator, List, Optional, Tuple, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V", bound=Hashable)


class BiMap(Generic[K, V]):
    def __init__(self, forward: Dict[K, V]) -> None:
        self._fwd: Dict[K, V] = dict(forward)
        self._inv: Dict[V, K] = {v: k for k, v in self._fwd.items()}
        if len(self._inv) != len(self._fwd):
            raise ValueError("BiMap requires values to be unique")

    @classmethod
    def string_int(cls, keys: Iterable[str]) -> "BiMap[str, int]":
        """Assign dense indices 0..n-1 in first-seen order (deterministic)."""
        fwd: Dict[str, int] = {}
        for k in keys:
            if k not in fwd:
                fwd[k] = len(fwd)
        return BiMap(fwd)

    def __getitem__(self, key: K) -> V:
        return self._fwd[key]

    def get(self, key: K, default: Optional[V] = None) -> Optional[V]:
        return self._fwd.get(key, default)

    def contains(self, key: K) -> bool:
        return key in self._fwd

    __contains__ = contains

    def inverse(self) -> "BiMap[V, K]":
        return BiMap(self._inv)

    def to_dict(self) -> Dict[K, V]:
        return dict(self._fwd)

    def keys(self) -> List[K]:
        return list(self._fwd.keys())

    def values(self) -> List[V]:
        return list(self._fwd.values())

    def items(self) -> List[Tuple[K, V]]:
        return list(self._fwd.items())

    def __iter__(self) -> Iterator[K]:
        return iter(self._fwd)

    def __len__(self) -> int:
        return len(self._fwd)

    def __eq__(self, other: object) -> bool:
        return isinstance(other, BiMap) and self._fwd == other._fwd

    def __repr__(self) -> str:
        return f"BiMap({len(self)} entries)"
