"""Model registry of the port (counterpart of mds_tpu/registry.py)."""

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._entries: Dict[str, Any] = {}

    def register(self, name: str) -> Callable[[Any], Any]:
        def deco(obj: Any) -> Any:
            if name in self._entries:
                raise KeyError(f"{self.name}: duplicate entry {name!r}")
            self._entries[name] = obj
            return obj

        return deco

    def __getitem__(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(f"{self.name}: unknown entry {name!r}; "
                           f"have {sorted(self._entries)}")
        return self._entries[name]


MODELS = Registry("models")
