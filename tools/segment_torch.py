#!/usr/bin/env python
"""Deploy CLI of the PyTorch port, with tools/segment.py's shape: compile |
run | test.

  python tools/segment_torch.py compile --config cfg.json --engine model.pt2 \\
      [--ckpt DIR] [--size 1024 2048] [--fp16] [--device cuda|cpu]
  python tools/segment_torch.py run model.pt2 in.npy|in.png out.npy|out.png
  python tools/segment_torch.py test model.pt2 [--iters 100]

The engine is a torch.export artifact (mds_tpu_torch/deploy/export.py) at a
fixed input size, on the device it was compiled for (the CUDA card unless
`--device cpu`); `run` and `test` run it there, and a CUDA engine needs a
card. `compile` builds the config's model as the eval CLI does
(evaluation/drivers.py `build_eval_bundle`: the seeded init, then the
latest checkpoint under --ckpt, else under ./res/ckpt) with the first
dataset's normalization in the graph. In f32 it takes the plain route;
`--fp16` compiles bf16 with every deploy route on (tools/serve_torch.py's
`serve_routes`), so the engine computes what serve_torch serves: the
hand-written kernels stay in the graph as custom ops. (JAX's `--fp16` sets
its stem kernel only.) `run` resizes the frame to the engine's size
(bilinear), nearest-resizes the labels back and writes them colored by
the palette of `default_rng(123)`. `test` prints the frames a second over
`--iters` calls (the device synchronized), then one JSON line with the
kernels' nodes in the graph and their launches a frame.

Images: a `.npy` path is an (H, W, 3) uint8 array, read and written with
numpy; any other path goes through PIL (tools/image_io_torch.py).
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def cmd_compile(args):
    import numpy as np
    import torch

    from mds_tpu_torch.config import Configer
    from mds_tpu_torch.data.labels import get_spec
    from mds_tpu_torch.deploy.export import export_model, save_exported
    from mds_tpu_torch.evaluation.drivers import build_eval_bundle

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("segment_torch compile needs a CUDA device; pass "
                           "--device cpu to compile for the CPU")
    configer = Configer(config_file=args.config)
    if args.fp16:
        from serve_torch import serve_routes

        serve_routes()
    dtype = torch.bfloat16 if args.fp16 else torch.float32
    model = build_eval_bundle(configer, ckpt=args.ckpt, device=args.device, dtype=dtype)
    spec_name = configer.dataset_cfg(0).get("spec")
    spec = get_spec(spec_name) if spec_name else None
    ep = export_model(model, tuple(args.size),
                      mean=spec.mean if spec else np.zeros(3, np.float32),
                      std=spec.std if spec else np.ones(3, np.float32),
                      device=args.device)
    save_exported(ep, args.engine)
    print(f"wrote {args.engine} ({os.path.getsize(args.engine) / 1e6:.1f} MB)")


def cmd_run(args):
    import numpy as np

    from image_io_torch import read_image, resize_labels, write_image
    from mds_tpu_torch.data.transforms import resize_image
    from mds_tpu_torch.deploy.export import load_exported_obj

    exported = load_exported_obj(args.engine)
    im = read_image(args.img)
    h, w = im.shape[:2]
    # the engine has a FIXED input size: resize in, nearest-resize the
    # label map back out
    im_in = resize_image(im, exported.input_shape[1:3])
    out = resize_labels(exported.infer(im_in[None])[0], (h, w))
    palette = np.random.default_rng(123).integers(0, 256, (256, 3), np.uint8)
    write_image(args.out, palette[out])
    print(f"wrote {args.out}")


def cmd_test(args):
    import numpy as np
    import torch

    from mds_tpu_torch.deploy.export import graph_ops, load_exported_obj
    from mds_tpu_torch.ops.custom_ops import KERNELS

    exported = load_exported_obj(args.engine)
    shape = exported.input_shape
    cuda = exported.device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    im = torch.from_numpy(np.random.default_rng(0).integers(0, 256, shape, np.uint8))
    im = im.to(exported.device)
    exported.call(im)
    sync()
    before = {k: w.launches for k, w in KERNELS.items()}
    n = args.iters
    t0 = time.perf_counter()
    for _ in range(n):
        exported.call(im)
    sync()
    dt = time.perf_counter() - t0
    print(f"{n / dt:.2f} FPS ({dt / n * 1000:.2f} ms/img) at {shape}")
    launches = {k: (w.launches - before[k]) / n for k, w in KERNELS.items()}
    print(json.dumps({
        "fps": n / dt, "ms": dt / n * 1000, "input_shape": list(shape),
        "device": torch.cuda.get_device_name(exported.device) if cuda else "cpu",
        "graph_ops": graph_ops(exported.program),
        "launches_per_frame": {k: v for k, v in launches.items() if v}}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    sub = ap.add_subparsers(dest="cmd", required=True)
    c = sub.add_parser("compile")
    c.add_argument("--config", required=True)
    c.add_argument("--ckpt", default=None)
    c.add_argument("--engine", required=True)
    c.add_argument("--size", type=int, nargs=2, default=[1024, 2048])
    c.add_argument("--fp16", action="store_true",
                   help="bf16 with every deploy route on (the served model)")
    c.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    c.set_defaults(fn=cmd_compile)
    r = sub.add_parser("run")
    r.add_argument("engine")
    r.add_argument("img")
    r.add_argument("out")
    r.set_defaults(fn=cmd_run)
    t = sub.add_parser("test")
    t.add_argument("engine")
    t.add_argument("--iters", type=int, default=100)
    t.set_defaults(fn=cmd_test)
    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
