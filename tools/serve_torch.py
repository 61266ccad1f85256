#!/usr/bin/env python
"""Serve a model of the PyTorch port over HTTP on the GPU (see
mds_tpu_torch/deploy/server.py for the protocol).

  python tools/serve_torch.py --config configs/bisenetv2_city.json \
      [--weights W.npz|W.pt] [--seed 0] [--size 1024 2048] [--port 8000] \
      [--name NAME] [--instances 2]
  python tools/serve_torch.py --engine model.pt2 [--port 8000] [--name NAME] \
      [--instances 2]

--engine serves an artifact of tools/segment_torch.py compile (the
counterpart of tools/serve.py): at its own input shape, on the device it
was exported for (a CUDA artifact needs a card), through the kernels and
routes it was exported with; --name defaults to bisenetv2.
  python tools/serve_torch.py --config configs/bisenetv1_city.json
  python tools/serve_torch.py --config configs/ltbgnn_3_datasets_snp.json
  python tools/serve_torch.py --config configs/hrnet_w48_city.json \
      [--weights hrnetv2_w48_imagenet_pretrained.pth]

The config's `model_name` picks the model (bisenetv2, bisenetv2_origin,
bisenetv1, snp_rn18, hrnet_w48 and its _gnn/_clip/_contrast names), built
by the trainer's `build_model`; --name, the name in the URL, defaults to
it. --weights takes an .npz of reference-layout keys
(mds_tpu_torch/deploy/weights.py) or a torch.save'd state dict; a
reference HRNet backbone checkpoint (ImageNet or multi-dataset layout) is
grafted into HRNet's backbone, the rest kept. Without it the weights are
a seeded random init, and the prototype models' (snp_rn18, HRNet)
bipartite graphs the identity graphs the alternating trainer starts from
(so that their labels are not all zero). Those serve their first
dataset's label space.
--instances bounds how many requests run the model at once.
The model runs in bf16 with the deploy kernels on, always on CUDA:
set_stem_impl("kernel") (the RGB stems of either model),
set_detail_fuse(True) (BiSeNetV2's fused DetailBranch head and StemBlock),
set_detail_tail(True) (the DetailBranch's last five convs as one more
kernel), set_depthwise_impl("kernel") (BiSeNetV2's 16 depthwise 3×3 convs)
and set_pred_impl("fused") (BiSeNetV2's ×8 upsample + argmax as one pass).
BiSeNetV1, snp_rn18 and HRNet have no DetailBranch, no depthwise conv
and no fused tail, so the last four leave them as they are; snp_rn18's
7×7 stem runs as kernel 6 at each of its 3 pyramid levels, HRNet's 3×3
RGB stem as kernel 1 once a frame.
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def serve_routes() -> None:
    """Switch on every deploy route of models/layers.py: the routes this
    tool serves a --config model on, and segment_torch.py --fp16 exports."""
    from mds_tpu_torch.models.layers import (
        set_depthwise_impl,
        set_detail_fuse,
        set_detail_tail,
        set_pred_impl,
        set_stem_impl,
    )

    set_stem_impl("kernel")
    set_detail_fuse(True)
    set_detail_tail(True)
    set_depthwise_impl("kernel")
    set_pred_impl("fused")


def build_e2e(config: str, weights=None, seed: int = 0, device: str = "cuda"):
    """Config (+ weights) → E2EModel in bf16 on `device`."""
    import numpy as np
    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.deploy.e2e import E2EModel
    from mds_tpu_torch.deploy.weights import load_reference_weights
    from mds_tpu_torch.engine.trainer import build_model
    from mds_tpu_torch.ops.uot_match import pretrain_bipartite_graphs

    cfg = Configer(config_file=config)
    model = build_model(cfg, torch.bfloat16, aux=False)
    model.init_weights(torch.Generator().manual_seed(seed))
    if hasattr(model, "set_bipartite_graphs"):
        model.set_bipartite_graphs(pretrain_bipartite_graphs(
            model.datasets_cats, model.max_num_unify_class))
    if weights:
        if weights.endswith(".npz"):
            with np.load(weights) as z:
                state = {k: z[k] for k in z.files}
        else:
            state = torch.load(weights, map_location="cpu", weights_only=True)
        load_reference_weights(model, state)
    spec_name = cfg.dataset_cfg(0).get("spec")
    spec = get_spec(spec_name) if spec_name else None
    mean = spec.mean if spec else np.zeros(3, np.float32)
    std = spec.std if spec else np.ones(3, np.float32)
    return E2EModel(model, mean, std, device=device)


def main():
    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--config")
    src.add_argument("--engine", help="an artifact of segment_torch.py compile")
    ap.add_argument("--weights", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=[1024, 2048])
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--name", default=None,
                    help="model name in the URL (default: the config's model_name)")
    ap.add_argument("--instances", type=int, default=2,
                    help="requests that run the model at once (default 2)")
    args = ap.parse_args()

    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.deploy.server import InferenceServer

    if args.engine:
        srv = InferenceServer(args.engine, name=args.name or "bisenetv2",
                              instances=args.instances)
        where = srv.model.device
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("serve_torch needs a CUDA device")
        name = args.name or Configer(config_file=args.config).get(
            "model_name", default="bisenetv2")
        serve_routes()
        srv = InferenceServer(build_e2e(args.config, args.weights, args.seed),
                              tuple(args.size), name=name, instances=args.instances)
        where = torch.device("cuda")
    if where.type == "cuda":
        where = torch.cuda.get_device_name(where)
    print(f"serving {srv.name} {srv.in_shape} on :{args.port} ({where})", flush=True)
    srv.serve(args.port)


if __name__ == "__main__":
    main()
