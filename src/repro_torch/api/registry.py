"""String-keyed strategy registries for the public pipeline API.

Every pluggable stage of the paper pipeline — partitioner, exchange
strategy, executor, solver — is a named entry in a :class:`Registry`.
New strategies land as registry entries (the EasyDeL config-registry
idiom), not as new scripts: register under a string key and every
caller of :func:`repro_torch.api.distribute` / :meth:`SparseSession.solve`
can select it by name.

    from repro_torch.api import register_partitioner

    @register_partitioner("my-blocked")
    def my_blocked(a, topology, *, seed=0):
        ...
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, TypeVar

__all__ = ["Registry"]

T = TypeVar("T")


class Registry:
    """A named string → strategy mapping with a decorator registrar."""

    def __init__(self, kind: str):
        self.kind = kind
        self._entries: Dict[str, Callable] = {}

    def register(self, name: str, obj: Optional[T] = None):
        """Register ``obj`` under ``name``; usable as a decorator.

        ``register("x")`` returns a decorator; ``register("x", fn)``
        registers immediately and returns ``fn``.
        """

        def _add(fn: T) -> T:
            if name in self._entries:
                raise ValueError(f"{self.kind} {name!r} already registered")
            self._entries[name] = fn
            return fn

        return _add(obj) if obj is not None else _add

    def get(self, name: str) -> Callable:
        try:
            return self._entries[name]
        except KeyError:
            raise KeyError(
                f"unknown {self.kind} {name!r}; known: {sorted(self._entries)}"
            ) from None

    def names(self) -> list:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._entries))

    def __len__(self) -> int:
        return len(self._entries)

    def __repr__(self) -> str:
        return f"Registry({self.kind}: {self.names()})"
