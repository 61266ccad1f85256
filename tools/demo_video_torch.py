#!/usr/bin/env python
"""Streaming frame-sequence demo of the PyTorch port, the counterpart of
tools/demo_video.py (reference: tools/demo_video.py — frames → batched
inference → palette frames, with producer/consumer queues).

  python tools/demo_video_torch.py --config cfg.json --frames DIR|frames.npy \\
      --out DIR|colors.npy [--ckpt DIR] [--batch 4] [--dataset 0] \\
      [--size 768 768] [--device cuda|cpu]

The stream is a directory of frames (.npy arrays or images PIL reads) or
one (N, H, W, 3) uint8 `.npy` stack. A decode thread resizes each frame to
--size and feeds batches of exactly --batch frames (the tail padded with
its last frame, whose labels are dropped); the model (demo_torch's: the
config's in bf16, every deploy route on the card) runs each batch on the
device; a writer thread colors the label maps with the spec's palette and
writes one file a frame into the --out directory (a frame of the stack as
frame_<i>.png), or, for an --out ending in .npy, one (N, H, W, 3) stack.
"""

import argparse
import os
import queue
import sys
import threading

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--frames", required=True, help="directory of frames or .npy")
    ap.add_argument("--out", required=True, help="directory, or a .npy stack")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dataset", type=int, default=0)
    ap.add_argument("--size", type=int, nargs=2, default=[768, 768])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from demo_torch import load_model, spec_of
    from image_io_torch import is_image, read_image, write_image
    from mds_tpu_torch.data.transforms import resize_image
    from mds_tpu_torch.deploy.e2e import E2EModel

    configer, model = load_model(args.config, args.ckpt, args.device)
    mean, std, palette = spec_of(configer, args.dataset)
    e2e = E2EModel(model, mean, std, args.dataset, device=args.device)
    h, w = args.size
    if args.frames.endswith(".npy"):
        frames = [(f"frame_{i:06d}.png", f) for i, f in enumerate(np.load(args.frames))]
    else:
        frames = [(n, None) for n in sorted(os.listdir(args.frames)) if is_image(n)]
    stack = args.out.endswith(".npy")
    if not stack:
        os.makedirs(args.out, exist_ok=True)

    in_q: "queue.Queue" = queue.Queue(maxsize=4)
    out_q: "queue.Queue" = queue.Queue(maxsize=4)
    failed = []
    colors = []

    def decode():
        try:
            batch, names = [], []
            for name, arr in frames:
                if arr is None:
                    arr = read_image(os.path.join(args.frames, name))
                batch.append(resize_image(arr, (h, w)))
                names.append(name)
                if len(batch) == args.batch:
                    in_q.put((np.stack(batch), names))
                    batch, names = [], []
            if batch:  # pad the tail to the fixed batch size
                batch += [batch[-1]] * (args.batch - len(batch))
                in_q.put((np.stack(batch), names))
        except BaseException as e:  # re-raised by the main thread
            failed.append(e)
        in_q.put(None)

    def write():
        try:
            while (item := out_q.get()) is not None:
                preds, names = item
                for p, name in zip(preds, names):
                    if stack:
                        colors.append(palette[p])
                    else:
                        write_image(os.path.join(args.out, name), palette[p])
        except BaseException as e:  # re-raised by the main thread
            failed.append(e)
            while out_q.get() is not None:  # let the main thread finish
                pass

    t_dec = threading.Thread(target=decode, daemon=True)
    t_wr = threading.Thread(target=write, daemon=True)
    t_dec.start()
    t_wr.start()
    n = 0
    try:
        while (item := in_q.get()) is not None:
            ims, names = item
            preds = e2e(torch.from_numpy(ims)).cpu().numpy()
            out_q.put((np.clip(preds[: len(names)], 0, 255), names))
            n += len(names)
    finally:
        out_q.put(None)
        t_wr.join()
    t_dec.join()
    if failed:
        raise RuntimeError("demo_video_torch: reading or writing frames failed") from failed[0]
    if stack:
        write_image(args.out, np.stack(colors) if colors else np.zeros((0, h, w, 3), np.uint8))
    print(f"processed {n} frames → {args.out}")


if __name__ == "__main__":
    main()
