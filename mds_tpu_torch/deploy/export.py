"""Model export for deployment: a torch.export artifact (`.pt2`).

Counterpart of mds_tpu/deploy/export.py, which serializes StableHLO: here
the e2e graph (uint8 NHWC frame → normalize → `model.pred` → int32 labels,
deploy/e2e.py `E2EModule`) is traced by `torch.export` at a fixed input size
on one device and saved by `torch.export.save`. The hand-written kernels
stay in the graph as `mds_tpu_torch::` custom ops (ops/custom_ops.py): the
routes switched on in models/layers.py when the model is exported are the
routes the artifact runs, and running it launches the kernels on a CUDA
artifact (their plain versions on a CPU one). The folded BN coefficients
and the packed kernel weights are made once, by one real frame before the
trace, and the artifact holds them as constants: no call repacks a weight.
The artifact runs on the device it was exported for.
"""

from __future__ import annotations

import json
import zipfile
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mds_tpu_torch.deploy.e2e import E2EModule

_META = "mds_tpu_torch.json"  # the artifact's extra file: {"device": ...}


def make_e2e_module(model: nn.Module, mean: Sequence[float], std: Sequence[float],
                    dataset: int = 0) -> E2EModule:
    """The e2e graph as a module that traces (reference: tools/demo.py
    E2EModel :646-710 — normalization inside the deployed graph); it runs on
    the device of the model's tensors."""
    m = E2EModule(model, mean, std, dataset)
    return m.to(next(model.parameters()).device)


def export_model(model: nn.Module, input_hw: Tuple[int, int], mean=None, std=None,
                 dataset: int = 0, device: str = "cuda") -> torch.export.ExportedProgram:
    """The e2e graph of `model` on `device` at a fixed (1, H, W, 3) uint8
    input, traced by torch.export with the route switches as they stand.
    One zero frame runs first, which builds every fold and packed weight the
    trace then holds as constants. A CUDA export needs a card."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("export_model: a CUDA export needs a CUDA device")
    mean = mean if mean is not None else np.zeros(3, np.float32)
    std = std if std is not None else np.ones(3, np.float32)
    m = make_e2e_module(model.to(device), mean, std, dataset)
    frame = torch.zeros((1, *input_hw, 3), dtype=torch.uint8, device=device)
    with torch.no_grad():
        m(frame)
        ep = torch.export.export(m, (frame,), strict=False)
    # torch.export asserts each cast's source dtype, device and layout at run
    # time (aten._assert_tensor_metadata, a node a `.to()`: 333 in BiSeNetV2's
    # served graph). The trace fixed them for the one input the artifact
    # takes, and on the card they cost more host time than the rest of the
    # graph (tools/export_bench_torch.py --split); they go, as Inductor drops
    # them.
    graph = ep.graph_module.graph
    for node in list(graph.nodes):
        if node.target is torch.ops.aten._assert_tensor_metadata.default and not node.users:
            graph.erase_node(node)
    ep.graph_module.recompile()
    return ep


def _user_input(ep: torch.export.ExportedProgram) -> torch.Tensor:
    """The fake tensor of the artifact's one user input."""
    (name,) = ep.graph_signature.user_inputs
    node = next(n for n in ep.graph.nodes if n.op == "placeholder" and n.name == name)
    return node.meta["val"]


def save_exported(ep: torch.export.ExportedProgram, path: str) -> None:
    """Write the artifact, with the device it runs on beside the graph."""
    meta = {"device": str(_user_input(ep).device)}
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta)})


class Exported:
    """A loaded artifact (the counterpart of jax.export's Exported):
    `.call(image_u8)` runs it under inference_mode on its device;
    `.input_shape` is its (1, H, W, 3) input (`in_avals`); `.program` the
    ExportedProgram."""

    def __init__(self, ep: torch.export.ExportedProgram):
        x = _user_input(ep)
        self.program = ep
        self.input_shape = tuple(int(d) for d in x.shape)
        self.device = x.device
        self._module = ep.module()

    @torch.inference_mode()
    def call(self, image_u8) -> torch.Tensor:
        """(1, H, W, 3) uint8 (tensor or array) → (1, H, W) int32 on the
        artifact's device."""
        image = torch.as_tensor(image_u8)
        if tuple(image.shape) != self.input_shape or image.dtype != torch.uint8:
            raise ValueError(f"expected uint8 {self.input_shape}, got "
                             f"{image.dtype} {tuple(image.shape)}")
        return self._module(image.to(self.device))

    def infer(self, image: np.ndarray) -> np.ndarray:
        """numpy in, numpy out (waits for the device), as E2EModel.infer."""
        image = np.require(image, np.uint8, ["C_CONTIGUOUS", "WRITEABLE"])
        return self.call(image).cpu().numpy()


def artifact_device(path: str) -> str:
    """The device an artifact was exported for, read without loading it."""
    with zipfile.ZipFile(path) as z:
        names = [n for n in z.namelist() if n.endswith(f"/extra/{_META}")]
        if not names:
            raise ValueError(f"{path}: not an artifact of mds_tpu_torch.deploy.export")
        return json.loads(z.read(names[0]))["device"]


def load_exported_obj(path: str) -> Exported:
    """Register the custom ops, then load the artifact; a CUDA artifact
    needs a card."""
    from mds_tpu_torch.ops import custom_ops  # noqa: F401 — registers the ops

    device = artifact_device(path)
    if device.startswith("cuda") and not torch.cuda.is_available():
        raise RuntimeError(f"{path} runs on {device}, and no CUDA device is present")
    return Exported(torch.export.load(path))


def load_exported(path: str):
    """The artifact as a callable (the 'deserialize engine' role,
    trt_dep.cpp:118-139)."""
    return load_exported_obj(path).call


def graph_text(ep: torch.export.ExportedProgram) -> str:
    """The exported graph as text, its kernels as `mds_tpu_torch.<name>`
    nodes (the counterpart of stablehlo_text)."""
    return str(ep.graph)


def graph_ops(ep: torch.export.ExportedProgram, namespace: str = "mds_tpu_torch",
              ) -> dict:
    """{op name: nodes} of the graph's ops in `namespace`: one node per
    kernel launch a frame."""
    out: dict = {}
    for n in ep.graph.nodes:
        if n.op == "call_function" and getattr(n.target, "namespace", None) == namespace:
            name = n.target.name().split("::")[1].split(".")[0]
            out[name] = out.get(name, 0) + 1
    return out


def computed_weights(ep: torch.export.ExportedProgram,
                     namespace: str = "mds_tpu_torch") -> list:
    """The tensor arguments of the graph's `namespace` ops that the graph
    computes, past each op's first (its input): [] when every weight, fold
    and packed table the kernels read is a parameter, buffer or constant of
    the artifact, made once and not per call."""
    inputs = set(ep.graph_signature.user_inputs)
    bad = []
    for n in ep.graph.nodes:
        if n.op != "call_function" or getattr(n.target, "namespace", None) != namespace:
            continue
        for a in n.args[1:]:
            for t in a if isinstance(a, (list, tuple)) else (a,):
                if isinstance(t, torch.fx.Node) and (t.op != "placeholder" or t.name in inputs):
                    bad.append(f"{n.name}: {t.name}")
    return bad
