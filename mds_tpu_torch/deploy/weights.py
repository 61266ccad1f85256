"""Weights for the port: JAX variables → state_dict, and reference files.

The port's module names are the reference torch layout that
mds_tpu/deploy/torch_import.py writes (`bisenetv2_to_torch`), so conversion
reuses its numpy-only key tables; only the per-dataset affine of
`bisenetv2_origin` differs. BatchNorm2d's `num_batches_tracked` (unused in
eval) may be absent: a state_dict without torch's version metadata loads
strictly without it.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
from torch import nn

_AUX_HEADS = ("aux2.", "aux3.", "aux4.", "aux5_4.")


def bisenetv2_state_dict_from_jax(params: Mapping,
                                  batch_stats: Mapping) -> Dict[str, torch.Tensor]:
    """JAX BiSeNetV2 variables (numpy arrays, nested dicts) → the port's
    state_dict, for load_state_dict(strict=True)."""
    from mds_tpu.deploy.torch_import import bisenetv2_to_torch

    out: Dict[str, np.ndarray] = {}
    for key, v in bisenetv2_to_torch(params, batch_stats).items():
        block, _, leaf = key.rpartition(".")
        if leaf in ("affine_weight", "affine_bias") and v.ndim == 2:
            # per-dataset affine: one BatchNorm2d(affine=True) per dataset
            for i, row in enumerate(v):
                out[f"{block}.bn.{i}.{leaf[len('affine_'):]}"] = row
        else:
            out[key] = v
    return {k: torch.from_numpy(np.array(v, np.float32)) for k, v in out.items()}


def load_reference_weights(model: nn.Module, state: Mapping) -> nn.Module:
    """Load a reference-layout mapping (numpy arrays or tensors) strictly.
    Aux-head entries are dropped when the model has no aux heads."""
    has_aux = hasattr(model, "aux2")
    sd = {k: torch.as_tensor(np.asarray(v)) for k, v in state.items()
          if has_aux or not k.startswith(_AUX_HEADS)}
    model.load_state_dict(sd, strict=True)
    return model
