"""Spiral-path video on the port (the counterpart of the JAX package's
``render_video`` script): renders the ``llff_render`` spiral poses of one
LLFF scene whole-frame, crops a 32-pixel border as the reference does, and
writes each frame as a PNG, then the mp4 at ``--video_fps``.

    python -m nerfool_tpu_torch.render_video \\
        --config configs/gnt/gnt_full.txt --rootdir . --eval_scenes fern \\
        [--video_frames 120 --video_fps 30] [--gnt_fused_attn on] \\
        [--compute_dtype bfloat16 --gnt_fused_chain on] \\
        [--device cuda] [--seed 0]

Sampling is deterministic, as in the reference's video renderer. GNT takes
the whole-chain kernel (``--gnt_fused_chain``; ``auto`` = on a CUDA card,
for bf16 renders) and the ray-attention kernel with ``--gnt_fused_attn on``
(``engine.frame_render_config``). Frames go to
``<eval_dataset>/<expname>_video/<scene>/NNN.png`` through the port's own
PNG writer; the mp4 is written beside them where ``imageio`` with an ffmpeg
backend imports, and otherwise one line says that the PNG sequence is the
output. The render itself runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from nerfool_tpu_torch.config import port_parser

CROP = 32  # the reference's border crop


def main(argv=None):
    """Render the spiral; returns {'out_dir', 'frames' (PNG paths),
    'seconds' (per frame, ending in a device synchronize), 'mp4' (path or
    None)}."""
    args = port_parser().parse_args(argv)
    args.det = True  # the reference's video renderer samples deterministically
    from nerfool_tpu_torch.data import dataset_dict
    from nerfool_tpu_torch.device import resolve_device
    from nerfool_tpu_torch.engine import frame_render_config
    from nerfool_tpu_torch.models.bundle import create_model
    from nerfool_tpu_torch.render.render_image import render_single_image
    from nerfool_tpu_torch.utils.cameras import get_rays
    from nerfool_tpu_torch.utils.vis import to8b, write_png

    device = resolve_device(args.device)
    scene = args.eval_scenes[0] if args.eval_scenes else "fern"
    dataset = dataset_dict["llff_render"](args, scenes=scene)
    bundle = create_model(args=args, seed=args.seed, device=device)
    cfg = frame_render_config(args, device)
    out_dir = os.path.join(args.eval_dataset, args.expname + "_video", scene)
    os.makedirs(out_dir, exist_ok=True)
    t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" \
        else (lambda: None)
    frames, paths, seconds = [], [], []
    n_frames = min(len(dataset), args.video_frames)
    for i in range(n_frames):
        t0 = time.perf_counter()
        data = dataset[i]
        cam = t(np.asarray(data["camera"]).reshape(-1)[:34])
        h, w = int(cam[0]), int(cam[1])
        rays_o, rays_d = get_rays(h, w, cam[2:18].reshape(4, 4),
                                  cam[18:34].reshape(4, 4))
        batch = {"ray_o": rays_o, "ray_d": rays_d,
                 "depth_range": t(data["depth_range"]).reshape(1, 2),
                 "camera": cam[None]}
        src_rgbs = t(data["src_rgbs"])
        src_cams = t(data["src_cameras"]).reshape(-1, 34)
        with torch.inference_mode():
            feats = bundle.extract_features(src_rgbs)
            ret = render_single_image(bundle.nets, batch, feats, cfg, h, w,
                                      src_rgbs, src_cams,
                                      chunk_size=args.chunk_size)
        level = ret["outputs_fine"] or ret["outputs_coarse"]
        frame = to8b(level["rgb"].float().cpu().numpy())
        sync()
        seconds.append(time.perf_counter() - t0)
        if frame.shape[0] > 2 * CROP and frame.shape[1] > 2 * CROP:
            frame = frame[CROP:-CROP, CROP:-CROP]
        frames.append(frame)
        paths.append(os.path.join(out_dir, f"{i:03d}.png"))
        write_png(paths[-1], frame)
        print(f"frame {i + 1}/{n_frames}: {seconds[-1]:.2f}s", flush=True)

    mp4 = os.path.join(out_dir, f"{scene}.mp4")
    try:
        import imageio.v2 as imageio

        imageio.mimwrite(mp4, frames, fps=args.video_fps, quality=8)
        print(f"wrote {mp4}")
    except (ImportError, ValueError, RuntimeError, OSError) as e:
        # no imageio or no ffmpeg backend: the PNG sequence is the output
        mp4 = None
        reason = (str(e).splitlines() or [""])[0]
        print(f"mp4 write unavailable ({type(e).__name__}: {reason}); kept "
              f"PNG frame sequence in {out_dir}")
    return {"out_dir": out_dir, "frames": paths, "seconds": seconds,
            "mp4": mp4}


if __name__ == "__main__":
    main()
