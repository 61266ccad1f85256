"""JSON configs with nested-key access — the port's own copy of the part of
mds_tpu/config.py it uses (`Configer.get`, `n_datasets`, `n_cats`,
`dataset_cfg`), over the same files under configs/."""

from __future__ import annotations

import copy
import json
from typing import Any, Dict, Optional


class Configer:
    """Nested-dict config: `get('lr', 'max_iter')` walks nested keys and
    returns `default` for a missing one; datasets are the 1-indexed
    `dataset1..datasetN` objects of the repo's JSON schema."""

    def __init__(self, config_file: Optional[str] = None,
                 configs: Optional[Dict[str, Any]] = None):
        if config_file is not None:
            if not config_file.endswith(".json"):
                raise ValueError(f"unsupported config file type: {config_file}")
            with open(config_file) as f:
                self.params_root = json.load(f)
        else:
            self.params_root = copy.deepcopy(configs or {})

    def get(self, *keys: str, default: Any = None) -> Any:
        node: Any = self.params_root
        for k in keys:
            if not isinstance(node, dict) or k not in node:
                return default
            node = node[k]
        return node

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
