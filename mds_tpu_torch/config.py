"""JSON and python-dict configs with nested-key access and CLI overrides —
the port's own copy of mds_tpu/config.py (`Configer` :29-159, its
`conditions` helper :165-225 and `set_cfg_from_file` :228), over the same
files under configs/.

`get('lr', 'max_iter')` walks nested keys and returns `default` for a
missing one; `get_strict` raises instead. Datasets are the 1-indexed
`dataset1..datasetN` objects of the repo's JSON schema. Overrides are
`a.b.c value` or `a.b.c=value` tokens whose values parse as Python literals
where they can (`_literal`) and stay strings otherwise.
"""

from __future__ import annotations

import ast
import copy
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional, Sequence


def _literal(value: str) -> Any:
    """A CLI override value: a Python literal where it parses, else the
    string itself."""
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


class Configer:
    """Nested-dict config (mds_tpu/config.py:29)."""

    def __init__(self, config_file: Optional[str] = None,
                 configs: Optional[Dict[str, Any]] = None,
                 args_parser: Optional[Sequence[str]] = None):
        if config_file is not None:
            self.params_root = self._load_file(config_file)
        else:
            self.params_root = copy.deepcopy(configs or {})
        if args_parser:
            self.apply_overrides(args_parser)

    @staticmethod
    def _load_file(path: str) -> Dict[str, Any]:
        if path.endswith(".json"):
            with open(path) as f:
                return json.load(f)
        if path.endswith(".py"):
            # a python-dict config: the module defines a dict named `cfg`
            spec = importlib.util.spec_from_file_location(
                "cfg_mod_" + os.path.basename(path)[:-3], path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            if hasattr(mod, "cfg"):
                return dict(mod.cfg)
            raise ValueError(f"python config {path} must define a dict `cfg`")
        raise ValueError(f"unsupported config file type: {path}")

    def get(self, *keys: str, default: Any = None) -> Any:
        node: Any = self.params_root
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

    def get_strict(self, *keys: str) -> Any:
        sentinel = object()
        v = self.get(*keys, default=sentinel)
        if v is sentinel:
            raise KeyError(f"config key not found: {'.'.join(keys)}")
        return v

    def exists(self, *keys: str) -> bool:
        sentinel = object()
        return self.get(*keys, default=sentinel) is not sentinel

    def add(self, keys, value: Any) -> None:
        """Set a key that must not exist yet."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        node = self.params_root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        if keys[-1] in node:
            raise KeyError(f"key already exists: {'.'.join(keys)}")
        node[keys[-1]] = value

    def update(self, keys, value: Any) -> None:
        """Set a key, creating the dicts on its path."""
        keys = [keys] if isinstance(keys, str) else list(keys)
        node = self.params_root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value

    def set(self, keys, value: Any) -> None:
        """add-or-update."""
        self.update(keys, value)

    def plus_one(self, *keys: str) -> int:
        """Increment an integer counter kept in the config."""
        v = self.get(*keys, default=0) or 0
        self.update(list(keys), v + 1)
        return v + 1

    def apply_overrides(self, remain: Sequence[str]) -> None:
        """Apply `a.b.c value` or `a.b.c=value` dotted-key overrides."""
        toks: List[str] = []
        for t in remain:
            if "=" in t and not t.startswith("-"):
                toks.extend(t.split("=", 1))
            else:
                toks.append(t.lstrip("-"))
        if len(toks) % 2 != 0:
            raise ValueError(f"odd number of override tokens: {toks}")
        for key, val in zip(toks[::2], toks[1::2]):
            self.update(key.split("."), _literal(val))

    def to_dict(self) -> Dict[str, Any]:
        return copy.deepcopy(self.params_root)

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.params_root, f, indent=2)

    def clone(self) -> "Configer":
        return Configer(configs=self.params_root)

    @property
    def n_datasets(self) -> int:
        return int(self.get("n_datasets", default=1))

    def dataset_cfg(self, i: int) -> Dict[str, Any]:
        """Dataset i (0-indexed) — the `dataset{i+1}` object."""
        d = self.get(f"dataset{i + 1}")
        if d is None:
            raise KeyError(f"dataset{i + 1} not in config")
        return d

    def n_cats(self, i: int) -> int:
        return int(self.dataset_cfg(i)["n_cats"])

    @property
    def conditions(self) -> "_ConditionHelper":
        return _ConditionHelper(self)

    def __repr__(self) -> str:
        return f"Configer({json.dumps(self.params_root)[:200]}…)"


class _ConditionHelper:
    """Config predicates (mds_tpu/config.py:165), as `configer.conditions`."""

    def __init__(self, configer: Configer):
        self.configer = configer

    @property
    def use_multi_dataset(self) -> bool:
        return self.configer.n_datasets > 1

    @property
    def pred_sw_offset(self) -> bool:
        return self.configer.exists("data", "pred_sw_offset")

    @property
    def pred_dt_offset(self) -> bool:
        return self.configer.exists("data", "pred_dt_offset")

    @property
    def use_sw_offset(self) -> bool:
        return self.configer.exists("data", "use_sw_offset")

    @property
    def use_dt_offset(self) -> bool:
        return self.configer.exists("data", "use_dt_offset")

    @property
    def use_ground_truth(self) -> bool:
        return self.config_equals(("use_ground_truth",), True)

    @property
    def pred_ml_dt_offset(self) -> bool:
        return self.configer.exists("data", "pred_ml_dt_offset")

    def loss_contains(self, name: str) -> bool:
        return name in (self.configer.get("loss", "type", default="") or "")

    def model_contains(self, name: str) -> bool:
        return name in (self.configer.get("model_name", default="") or "")

    def config_equals(self, key: Sequence[str], value: Any) -> bool:
        if not self.configer.exists(*key):
            return False
        return self.configer.get(*key) == value

    def config_exists(self, key: Sequence[str]) -> bool:
        return self.configer.exists(*key)

    def environ_exists(self, key: str) -> bool:
        return os.environ.get(key) is not None


def set_cfg_from_file(path: str) -> Configer:
    """mds_tpu/config.py:228."""
    return Configer(config_file=path)
