#!/usr/bin/env python
"""Single-image inference demo of the PyTorch port, the counterpart of
tools/demo.py (reference: tools/demo.py — E2EModel wraps normalize into
the graph :646-710, palette rendering :767-773).

  python tools/demo_torch.py --config cfg.json [--ckpt DIR] --img in.npy|in.png \\
      [--out res.png] [--dataset 0] [--size 768 768] [--device cuda|cpu]

The model is the config's, built as the eval CLI builds it (bf16;
evaluation/drivers.py `build_eval_bundle`: the seeded init, then the latest
checkpoint under --ckpt, else under ./res/ckpt). On the card it runs with
every deploy route on (tools/serve_torch.py `serve_routes`); it runs on the
CUDA card unless `--device cpu`. The frame goes to --size when given, then
down to a multiple of 32 (BiSeNetV2's BGA merges the 1/8 detail path with
the ×4-upsampled 1/32 path), and the label map comes back to --size (else
the frame's size) by nearest resize, colored by the dataset spec's palette
(else that of `default_rng(123)`). A `.npy` path is an (H, W, 3) uint8
array; any other path goes through PIL (tools/image_io_torch.py).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def round_to_32(hw):
    """Each side down to a multiple of 32, at least 32 (the reference
    rounds eval sizes the same way, evaluate.py get_round_size :43)."""
    return tuple(max(32, (d // 32) * 32) for d in hw)


def load_model(config: str, ckpt, device: str):
    """(configer, model) for the demos: the config's model in bf16 on
    `device`, with every deploy route on for a card."""
    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.evaluation.drivers import build_eval_bundle

    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("the demo needs a CUDA device; pass --device cpu to "
                               "run it on the CPU")
        from serve_torch import serve_routes

        serve_routes()
    configer = Configer(config_file=config)
    return configer, build_eval_bundle(configer, ckpt=ckpt, device=device)


def spec_of(configer, dataset: int):
    """The dataset's label spec (None without one), its normalization and
    its palette (else the seeded one)."""
    import numpy as np

    from mds_tpu_torch.data.labels import get_spec

    name = configer.dataset_cfg(dataset).get("spec")
    spec = get_spec(name) if name else None
    if spec is None:
        return (np.zeros(3, np.float32), np.ones(3, np.float32),
                np.random.default_rng(123).integers(0, 256, (256, 3), np.uint8))
    return spec.mean, spec.std, spec.palette


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--img", required=True)
    ap.add_argument("--out", default="res.png")
    ap.add_argument("--dataset", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np

    from image_io_torch import read_image, resize_labels, write_image
    from mds_tpu_torch.data.transforms import resize_image
    from mds_tpu_torch.deploy.e2e import E2EModel

    configer, model = load_model(args.config, args.ckpt, args.device)
    mean, std, palette = spec_of(configer, args.dataset)
    im = read_image(args.img)
    if args.size:
        im = resize_image(im, tuple(args.size))
    target_hw = im.shape[:2]
    im = resize_image(im, round_to_32(target_hw))
    e2e = E2EModel(model, mean, std, args.dataset, device=args.device)
    pred = resize_labels(e2e.infer(im[None])[0], target_hw)
    write_image(args.out, palette[pred])
    print(f"wrote {args.out} (pred classes: {sorted(set(pred.ravel().tolist()))[:20]})")


if __name__ == "__main__":
    main()
