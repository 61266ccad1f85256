#!/usr/bin/env python
"""BiSeNetV2's served frame on one CUDA card, eager and as a deploy
artifact: configs/bisenetv2_city.json (19 classes, bf16, seeded weights,
random BN statistics, as chip_smoke.py's slice phase builds it) at
1024×2048 with every deploy route on (tools/serve_torch.py's).

  python tools/export_bench_torch.py [--tree DIR] [--n 20] [--rounds 3] [--split]

Prints the card (name, power limit, SM clock) and one JSON line: the
eager E2EModel frame's ms and, where the tree has deploy/export.py, the
artifact's (torch.export on the card, saved and loaded back), each the
median of --n CUDA-event runs after 3 warm-up ones, in --rounds rounds of
eager then artifact. `--split` adds two variants of the artifact's graph,
timed in the same rounds: the graph as torch.export gives it, with the
`aten._assert_tensor_metadata` nodes that export_model removes
(`asserts`), and the artifact's custom-op nodes calling their Python
bodies (the kernels' wrappers) directly instead of through the dispatcher
(`bodies`). `--tree` times another checkout's package (the
parent's, unpacked with `git archive` into a git-ignored directory), whose
eager frame is the one before the kernels became custom ops; compare two
trees in one call, in turns: parent, change, change, parent, each its own
process.
"""

import argparse
import json
import os
import tempfile

import numpy as np
import torch

from bench_util_torch import ROOT, cuda_ms, open_tree, print_card

CONFIG = str(ROOT / "configs" / "bisenetv2_city.json")


def served_model():
    from mds_tpu_torch import MODELS
    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.deploy.e2e import E2EModel
    from mds_tpu_torch.models import layers

    cfg = Configer(config_file=CONFIG)
    spec = get_spec(cfg.dataset_cfg(0)["spec"])
    model = MODELS["bisenetv2"](n_classes=(19,), aux=False, dtype=torch.bfloat16)
    model.init_weights(torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.copy_(torch.randn(m.num_features, generator=gen) * 0.1)
                m.running_var.copy_(torch.rand(m.num_features, generator=gen) + 0.5)
    layers.set_stem_impl("kernel")
    layers.set_detail_fuse(True)
    layers.set_detail_tail(True)
    layers.set_depthwise_impl("kernel")
    layers.set_pred_impl("fused")
    return E2EModel(model, spec.mean, spec.std, device="cuda"), spec


def split_variants(e2e, spec, frame, path):
    """Two variants of the artifact at `path`: BiSeNetV2's served graph as
    torch.export gives it (after export_model's real frame), its metadata
    assertions kept; the artifact with its custom ops called as their
    bodies."""
    from mds_tpu_torch.deploy.export import make_e2e_module
    from mds_tpu_torch.ops import custom_ops

    m = make_e2e_module(e2e.model, spec.mean, spec.std)
    with torch.no_grad():
        raw = torch.export.export(m, (frame.cuda(),), strict=False)
    ep = torch.export.load(path)
    for node in ep.graph_module.graph.nodes:
        if getattr(node.target, "namespace", None) == "mds_tpu_torch":
            op = node.target.name().split("::")[1].split(".")[0]
            node.target = getattr(custom_ops, op)._init_fn
    ep.graph_module.recompile()
    return {"asserts": raw.module(), "bodies": ep.module()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--split", action="store_true")
    args = ap.parse_args()
    tree = open_tree(args.tree, "export_bench_torch")
    print_card()
    e2e, spec = served_model()
    frame = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (1, 1024, 2048, 3)).astype(np.uint8))
    art, variants = None, {}
    if (tree / "mds_tpu_torch" / "deploy" / "export.py").exists():
        from mds_tpu_torch.deploy import export as ex

        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "v2.pt2")
            ex.save_exported(ex.export_model(e2e.model, (1024, 2048), spec.mean, spec.std,
                                             device="cuda"), path)
            art = ex.load_exported_obj(path)
            if args.split:
                variants = split_variants(e2e, spec, frame, path)
    rec = {"eager_ms": [], "artifact_ms": [] if art else None,
           **{f"{k}_ms": [] for k in variants}}
    for _ in range(args.rounds):
        rec["eager_ms"].append(cuda_ms(lambda: e2e(frame), args.n))
        if art:
            rec["artifact_ms"].append(cuda_ms(lambda: art.call(frame), args.n))
        with torch.inference_mode():
            for k, mod in variants.items():
                rec[f"{k}_ms"].append(cuda_ms(lambda: mod(frame.cuda()), args.n))
    print(json.dumps({"tree": str(tree), **rec}), flush=True)


if __name__ == "__main__":
    main()
