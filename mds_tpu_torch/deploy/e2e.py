"""uint8 frame → normalize → model → argmax, on an explicit device.

Counterpart of mds_tpu/deploy/export.py `make_e2e_fn`: the normalization
lives inside the served graph, input (1, H, W, 3) uint8 NHWC, output
(1, H, W) int32 labels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn


class E2EModel(nn.Module):
    def __init__(self, model: nn.Module, mean: Sequence[float],
                 std: Sequence[float], dataset: int = 0,
                 device: str | torch.device = "cuda"):
        super().__init__()
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.register_buffer(
            "mean", torch.as_tensor(np.asarray(mean, np.float32), device=self.device))
        self.register_buffer(
            "std", torch.as_tensor(np.asarray(std, np.float32), device=self.device))
        self.dataset = dataset

    @torch.inference_mode()
    def forward(self, image_u8: torch.Tensor) -> torch.Tensor:
        """(1, H, W, 3) uint8 → (1, H, W) int32, on this model's device."""
        x = image_u8.to(self.device).float() / 255.0
        x = (x - self.mean) / self.std
        # NHWC memory seen as NCHW is channels_last, which the kernels take
        x = x.to(self.model.dtype).permute(0, 3, 1, 2)
        return self.model.pred(x, self.dataset).to(torch.int32)

    def infer(self, image: np.ndarray) -> np.ndarray:
        """numpy in, numpy out (waits for the device)."""
        image = np.require(image, np.uint8, ["C_CONTIGUOUS", "WRITEABLE"])
        return self(torch.from_numpy(image)).cpu().numpy()
