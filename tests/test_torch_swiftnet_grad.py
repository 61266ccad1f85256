"""The gradient of the port's SwiftNet pyramid (mds_tpu_torch/models/
swiftnet.py) against JAX's (mds_tpu/models/swiftnet.py) on the CPU at f32,
at the tiny widths of tests/torch_flagship_parity.py (a file of its own:
JAX's gradient compiles for about 20 s cold)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from torch_flagship_parity import KW, jax_pyramid, nchw, one_torch_thread, rel  # noqa: F401
from mds_tpu_torch.deploy.weights import swiftnet_to_torch
from mds_tpu_torch.models import swiftnet as ts

F32 = 1e-4


def test_pyramid_gradient_matches_jax():
    """The gradient of a weighted sum of the train output wrt every
    parameter at 72×72, rel ≤ 1e-4 per tensor, or else the port's f32
    gradient within twice JAX's distance from the exact one (the port in
    f64 on the same weights): the deepest level's BNs see 3 values a
    channel at this size, and their gradients part by up to 2e-4 (as
    tests/torch_parity.py measures the BiSeNetV2 step)."""
    hw = (72, 72)
    jm, v, tm = jax_pyramid()
    rng = np.random.default_rng(2)
    xs = [rng.normal(0, 1, (2, *hw, 3)).astype(np.float32),
          rng.normal(0, 1, (1, *hw, 3)).astype(np.float32)]
    vj = jax.tree_util.tree_map(jnp.asarray, v)
    jx = [jnp.asarray(x) for x in xs]
    weights = [rng.normal(0, 1, (b, 18, 18, 16)).astype(np.float32) for b in (2, 1)]

    def jloss(params):
        out, _ = jm.apply({"params": params, "batch_stats": vj["batch_stats"]}, jx,
                          train=True, mutable=["batch_stats"])
        return sum(jnp.sum(o * w) for o, w in zip(out, weights))

    jgrad = swiftnet_to_torch(jax.tree_util.tree_map(np.asarray, jax.jit(jax.grad(jloss))(
        vj["params"])), v["batch_stats"], prefix="")
    grads = []
    for dtype in (torch.float32, torch.float64):
        m = ts.SwiftNetPyramid(**KW, dtype=dtype)
        m.load_state_dict(tm.state_dict())
        m.to(dtype).train()
        out = m([nchw(x).to(dtype) for x in xs])
        sum((o * nchw(w).to(dtype)).sum() for o, w in zip(out, weights)).backward()
        grads.append({n: p.grad.double().numpy() for n, p in m.named_parameters()})
    port, exact = grads
    bad = {}
    for k, g in port.items():
        r_pj, r_p, r_j = rel(g, jgrad[k]), rel(g, exact[k]), rel(jgrad[k], exact[k])
        if not (r_pj <= F32 or r_p <= 2 * r_j):
            bad[k] = (r_pj, r_p, r_j)
    assert not bad, bad
