"""chip_smoke.py's logits gate against the model in f32, on the CPU.

`largest_call_rels(..., f32_model=...)` measures the routed and the plain
bf16 logits of each call against the model in f32 and fails a call whose
route is more than F32_RATIO_GATE times as far from f32 as the plain path.
Here a small cosine head (a 1×1 conv, ReLU, a 1×1 conv, unit-normalized
features against unit-normalized prototypes, as the contrast family's and
snp_rn18's clip logits are) runs in bf16 on one seeded image. The gate
must pass a route that is the plain path itself and a route that keeps
its input and middle activation in f32, and refuse one whose kernel is 3%
off on a quarter of the channels (a cosine head does not see a fault that
scales all channels alike). That route is 0.016 from f32 and from the
plain path, within LOGITS_GATE of both: only the ratio refuses it.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch import nn

import chip_smoke
from mds_tpu_torch.evaluation import evaluator

MEAN, STD = (0.5, 0.5, 0.5), (0.25, 0.25, 0.25)


class CosineHead(nn.Module):
    def __init__(self, seed=0, chans=32, classes=7):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w1 = nn.Parameter(torch.randn(chans, 3, generator=g))
        self.w2 = nn.Parameter(torch.randn(chans, chans, generator=g) / chans ** 0.5)
        self.prototypes = nn.Parameter(torch.randn(classes, chans, generator=g))
        self.dtype = torch.bfloat16
        self.variant = "plain"

    def eval_logits(self, x, dataset=0):
        dt = torch.float32 if self.variant == "closer" else self.dtype
        h = torch.einsum("nchw,kc->nkhw", x.to(dt), self.w1.to(dt)).relu()
        f = torch.einsum("nchw,kc->nkhw", h, self.w2.to(h.dtype))
        if self.variant == "faulty":
            f = torch.cat([f[:, :8] * 1.03, f[:, 8:]], dim=1)
        f = F.normalize(f.to(self.dtype).float(), dim=1).to(self.dtype)
        p = F.normalize(self.prototypes.float(), dim=1).to(self.dtype)
        return torch.einsum("nkhw,ck->nchw", f, p)


def _routed(model, variant):
    """The logits function whose first call is the plain path and whose
    second (largest_call_rels' routed call) runs `variant`."""
    base = evaluator.make_logits_fn(model, MEAN, STD)
    calls = []

    def fn(im, dataset):
        model.variant = variant if calls else "plain"
        calls.append(variant)
        return base(im, dataset)

    return fn


@pytest.mark.parametrize("variant,passes", [("plain", True), ("closer", True),
                                            ("faulty", False)])
def test_f32_ratio_gate(variant, passes):
    model = CosineHead().to(torch.bfloat16)
    f32 = chip_smoke.f32_copy(model)
    rng = np.random.default_rng(3)
    im = torch.from_numpy(rng.uniform(0, 255, (1, 3, 32, 64)).astype(np.float32))
    calls = [(_routed(model, variant), im, 0, ((model, MEAN, STD), {}))]
    out, bad = chip_smoke.largest_call_rels(calls, {}, (), f32_model=f32)
    routed, plain = out[0]["f32"]["routed"], out[0]["f32"]["plain"]
    assert plain > 0  # the bf16 head is off f32 at all
    assert (not bad) == passes, (variant, routed, plain, bad)
    if variant == "plain":
        assert routed == plain and out[0]["rel"] == 0
