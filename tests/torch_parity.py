"""Shared helpers of the tests/test_torch_*.py parity tests: JAX variables
made non-trivial from a numpy seed, converted to the port, and compared."""

import numpy as np
import torch

from mds_tpu_torch.deploy.weights import load_reference_weights


def randomize_variables(v, rng):
    """Copy of a JAX variables tree (as numpy) with non-trivial BN: running
    mean ~N(0, 0.1), var ~U(0.5, 1.5), BN scale ~N(1, 0.1), every bias
    ~N(0, 0.1)."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(x, path + (k,)) for k, x in node.items()}
        a = np.asarray(node, np.float32)
        leaf = path[-1]
        if leaf == "mean":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        if leaf == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if leaf == "scale":
            return rng.normal(1, 0.1, a.shape).astype(np.float32)
        if leaf == "bias":
            return rng.normal(0, 0.1, a.shape).astype(np.float32)
        return a

    return walk({k: v[k] for k in v}, ())


def oihw(k):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(k).transpose(3, 2, 0, 1)))


def convbn_state(p, s, prefix=""):
    """One JAX ConvBNReLU's variables (shared affine) → the port's
    reference-layout keys."""
    sd = {f"{prefix}conv.weight": oihw(p["conv"]["kernel"]),
          f"{prefix}affine_weight": p["bn"]["scale"],
          f"{prefix}affine_bias": p["bn"]["bias"]}
    for i in range(np.asarray(s["bn"]["mean"]).shape[0]):
        sd[f"{prefix}bn.{i}.running_mean"] = s["bn"]["mean"][i]
        sd[f"{prefix}bn.{i}.running_var"] = s["bn"]["var"][i]
    return sd


def load(module, state):
    return load_reference_weights(module, state).eval()


def nchw(x_nhwc, dtype=torch.float32):
    """numpy NHWC → torch NCHW stored channels_last."""
    return torch.from_numpy(np.array(x_nhwc, np.float32)).to(dtype).permute(0, 3, 1, 2)


def nhwc(t):
    """torch NCHW → numpy NHWC f32."""
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def rel_err(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))
