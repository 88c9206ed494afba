"""CLI/config-flag system (the port's own copy of ``nerfool_tpu/config.py``:
same flags, same defaults, so one command line drives either package).

The union of the reference's IBRNet and GNT parsers (reference
config.py:19-223, reference eval/gnt/config.py:4-311) plus a ``--backbone``
selector, without the configargparse dependency: ``--config file.txt`` files
in the same ``key = value`` format are merged as defaults (CLI wins).
``port_parser`` adds the port's own flags (``--device``, ``--seed``,
``--max_views``, ``--dataset_kwargs``).

Flags of dispatch formulations the port does not have (``--scan_group``,
``--shard_rays``, the sample and ray folds, ``--matmul_precision``,
``--attack_spg``/``--attack_gather``) parse and map to the port's one path.
"""
from __future__ import annotations

import argparse
import dataclasses
import shlex
import sys


def str2bool(v):
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "yes", "1"):
        return True
    if v.lower() in ("false", "no", "0"):
        return False
    raise argparse.ArgumentTypeError(f"boolean value expected, got {v!r}")


def on_off_auto(v):
    """'auto', 'on' or 'off'; a boolean value parses as 'on' or 'off'."""
    if isinstance(v, bool):
        return "on" if v else "off"
    if v.lower() in ("auto", "on", "off"):
        return v.lower()
    return "on" if str2bool(v) else "off"


def from_flags(cls, args, **given):
    """The dataclass ``cls`` with the fields ``given`` and every other
    field read from the parsed flag of its name."""
    return cls(**given, **{f.name: getattr(args, f.name)
                           for f in dataclasses.fields(cls)
                           if f.name not in given})


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with configargparse-style '--config file' default merging."""

    def parse_args(self, args=None, namespace=None):
        args = list(sys.argv[1:] if args is None else args)
        cfg_path = None
        for i, a in enumerate(args):
            if a == "--config" and i + 1 < len(args):
                cfg_path = args[i + 1]
            elif a.startswith("--config="):
                cfg_path = a.split("=", 1)[1]
        if cfg_path:
            file_args = []
            for key, vals in _read_config_file(cfg_path):
                action = self._option_string_actions.get(f"--{key}")
                if isinstance(
                    action, (argparse._StoreTrueAction, argparse._StoreFalseAction)
                ):
                    # configargparse style: `flag = True` sets store_true flags,
                    # `flag = False` leaves the default
                    try:
                        enabled = len(vals) == 1 and str2bool(vals[0])
                    except argparse.ArgumentTypeError as e:
                        self.error(f"argument --{key} (from {cfg_path}): {e}")
                    if enabled:
                        file_args.append(f"--{key}")
                else:
                    file_args.append(f"--{key}")
                    file_args.extend(vals)
            # file entries act as defaults: prepend so explicit CLI wins
            args = file_args + args
        return super().parse_args(args, namespace)


def _read_config_file(path):
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            if "=" in line:
                key, val = line.split("=", 1)
            else:
                parts = line.split(None, 1)
                key, val = parts[0], parts[1] if len(parts) > 1 else "true"
            key = key.strip()
            val = val.strip()
            if val.startswith("[") and val.endswith("]"):
                out.append((key, shlex.split(val[1:-1].replace(",", " "))))
            else:
                out.append((key, shlex.split(val)))
    return out


def config_parser():
    parser = ConfigArgumentParser()
    # general
    parser.add_argument("--config", type=str, help="config file path")
    parser.add_argument("--rootdir", type=str, default="./",
                        help="project root (datasets under <rootdir>/data)")
    parser.add_argument("--expname", type=str, default="exp", help="experiment name")
    parser.add_argument("--backbone", type=str, default="ibrnet",
                        choices=["ibrnet", "gnt", "pixelnerf"],
                        help="aggregation backbone")
    parser.add_argument("--distributed", action="store_true")
    parser.add_argument("--local_rank", type=int, default=0)
    parser.add_argument("-j", "--workers", default=8, type=int)

    # dataset
    parser.add_argument("--train_dataset", type=str, default="ibrnet_collected")
    parser.add_argument("--dataset_weights", nargs="+", type=float, default=[])
    parser.add_argument("--train_scenes", nargs="+", default=[])
    parser.add_argument("--eval_dataset", type=str, default="llff_test")
    parser.add_argument("--eval_scenes", nargs="+", default=[])
    parser.add_argument("--testskip", type=int, default=8)

    # ray sampling
    parser.add_argument("--sample_mode", type=str, default="uniform")
    parser.add_argument("--center_ratio", type=float, default=0.8)
    parser.add_argument("--N_rand", type=int, default=32 * 16)
    parser.add_argument("--chunk_size", type=int, default=1024 * 4)

    # model
    parser.add_argument("--coarse_feat_dim", type=int, default=32)
    parser.add_argument("--fine_feat_dim", type=int, default=32)
    parser.add_argument("--num_source_views", type=int, default=10)
    parser.add_argument("--rectify_inplane_rotation", action="store_true")
    parser.add_argument("--coarse_only", action="store_true")
    parser.add_argument("--anti_alias_pooling", type=int, default=1)
    # computation dtypes (no reference counterpart). compute_dtype drives the
    # aggregation/render path (RenderConfig); feature_dtype the ResUNet's
    # convolutions (its outputs stay float32)
    parser.add_argument("--compute_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    parser.add_argument("--feature_dtype", type=str, default="float32",
                        choices=["float32", "bfloat16"])
    # parses only: the port pins full-f32 products and convolutions (TF32
    # off) at package import
    parser.add_argument("--matmul_precision", type=str, default="default",
                        choices=["default", "high", "highest"])
    # parses only: the port runs on one device
    parser.add_argument("--shard_rays", type=str2bool, default=True)
    # per-ray segment-patch gather for the attack's random-pixel ray batches:
    # not ported, the three flags below map to the per-tap gather
    parser.add_argument("--attack_spg", type=str2bool, default=False)
    parser.add_argument("--attack_gather", type=str, default="auto",
                        choices=["auto", "spg", "tap"])
    parser.add_argument("--attack_spg_min_views", type=int, default=10)
    # block segment-patch gather for whole-image eval renders (ops/bspg.py;
    # no reference counterpart): contiguous per-(block, view) patch fetches
    # replace the random per-tap gathers
    parser.add_argument("--use_bspg", type=str2bool, default=True)
    # BSPG pixel-block edge (8 or 16): larger blocks halve the patch chains
    # per view but raise per-block selection work
    parser.add_argument("--bspg_block", type=int, default=8)
    # parses only: the port runs every attack iteration as its own eager
    # step
    parser.add_argument("--scan_group", type=int, default=None)
    # checkpoint the universal-attack state (delta, camera params, Adam
    # moments) every N iterations into out_dir/attack_state.pkl and resume
    # from it on restart; 0 disables (the reference keeps attack state only
    # in memory — SURVEY.md §5)
    parser.add_argument("--i_attack_ckpt", type=int, default=0)
    # gnt-specific
    parser.add_argument("--netwidth", type=int, default=64)
    parser.add_argument("--trans_depth", type=int, default=4)
    # lane packings of the GNT aggregator: parse only, the port has one
    # unpacked path
    parser.add_argument("--gnt_sample_fold", type=int, default=1)
    parser.add_argument("--gnt_ray_fold", type=int, default=1)
    # fused ray-attention kernel (ops/ray_attention.py) on the no-grad f32
    # GNT renders: 'on' forces it, 'auto' resolves to off
    parser.add_argument("--gnt_fused_attn", type=str, default="auto",
                        choices=("auto", "on", "off"))
    # whole-chain aggregation kernel (ops/chain.py) on bf16 no-grad GNT
    # renders: auto = on a CUDA device
    parser.add_argument("--gnt_fused_chain", type=str, default="auto",
                        choices=("auto", "on", "off"))
    # also route the differentiated attack step through the fused
    # ray-attention kernel, whose autograd.Function has a recomputing backward
    # kernel (ops/ray_attention.py)
    parser.add_argument("--gnt_fused_attack", type=str2bool, default=False)
    parser.add_argument("--ibrnet_sample_fold", type=int, default=1)
    parser.add_argument("--single_net", type=str2bool, default=True)
    parser.add_argument("--ret_alpha", action="store_true")

    # checkpoints
    parser.add_argument("--no_reload", action="store_true")
    parser.add_argument("--ckpt_path", type=str, default="")
    parser.add_argument("--no_load_opt", action="store_true")
    parser.add_argument("--no_load_scheduler", action="store_true")

    # training schedule
    parser.add_argument("--n_iters", type=int, default=250000)
    parser.add_argument("--lrate_feature", type=float, default=1e-3)
    parser.add_argument("--lrate_mlp", type=float, default=5e-4)
    parser.add_argument("--lrate_gnt", type=float, default=5e-4)
    parser.add_argument("--lrate_decay_factor", type=float, default=0.5)
    parser.add_argument("--lrate_decay_steps", type=int, default=50000)

    # rendering
    parser.add_argument("--N_samples", type=int, default=64)
    parser.add_argument("--N_importance", type=int, default=64)
    parser.add_argument("--inv_uniform", action="store_true")
    parser.add_argument("--det", action="store_true")
    parser.add_argument("--white_bkgd", action="store_true")
    parser.add_argument("--render_stride", type=int, default=1)
    parser.add_argument("--reuse_fine_taps", type=str2bool, default=True,
                        help="parses only: the port re-gathers every fine "
                             "sample")

    # logging
    parser.add_argument("--i_print", type=int, default=100)
    parser.add_argument("--i_img", type=int, default=500)
    parser.add_argument("--i_weights", type=int, default=10000)

    # eval
    parser.add_argument("--distributed_init_method", type=str, default="env://")
    parser.add_argument("--llffhold", type=int, default=8)
    parser.add_argument("--llff_factor", type=int, default=4)
    parser.add_argument("--random_crop", action="store_true")
    parser.add_argument("--depth_var_loss", type=float, default=0)

    # ---- attack flags
    parser.add_argument("--adv_iters", type=int, default=100)
    parser.add_argument("--epsilon", type=int, default=8)
    parser.add_argument("--adv_lr", type=float, default=2)
    parser.add_argument("--use_clean_color", action="store_true")
    parser.add_argument("--use_clean_density", action="store_true")
    parser.add_argument("--orig_dist_thres", type=float, default=-1)
    parser.add_argument("--export_adv_source_img", action="store_true")
    parser.add_argument("--depth_smooth_loss", type=float, default=0)
    parser.add_argument("--patch_size", type=int, default=8)
    parser.add_argument("--depth_consistency_loss", type=float, default=0)
    parser.add_argument("--ds_rgb", action="store_true")
    # general consistency-render scale under --ds_rgb; the reference's
    # RaySamplerSingleImage(resize_factor=...) (sample_ray.py:78-83) is
    # instantiated with 0.5 by its evaluators (eval_adv.py:354)
    parser.add_argument("--resize_factor", type=float, default=0.5)
    parser.add_argument("--depth_diff_loss", type=float, default=0)
    parser.add_argument("--use_patch_sampling", action="store_true")
    parser.add_argument("--gt_depth_path", type=str, default="")
    parser.add_argument("--use_pseudo_gt", action="store_true")
    parser.add_argument("--view_specific", action="store_true")
    parser.add_argument("--use_unseen_views", action="store_true")
    parser.add_argument("--no_attack", action="store_true")
    parser.add_argument("--use_adam", action="store_true")
    parser.add_argument("--adam_lr", type=float, default=0)
    parser.add_argument("--lr_step_size", type=int, default=100)
    parser.add_argument("--lr_gamma", type=float, default=0.5)
    parser.add_argument("--use_pcgrad", action="store_true")
    parser.add_argument("--major_loss", type=str, default="")
    parser.add_argument("--use_dp", action="store_true")
    parser.add_argument("--use_center_view", action="store_true")
    parser.add_argument("--density_loss", type=float, default=0)
    parser.add_argument("--interp_upbound", type=float, default=1.0)
    parser.add_argument("--decouple_interp_range", action="store_true")
    parser.add_argument("--interp_upbound_rot", type=float, default=1.0)
    parser.add_argument("--interp_upbound_trans", type=float, default=1.0)
    parser.add_argument("--sample_based_on_depth", action="store_true")
    parser.add_argument("--beta", type=float, default=0.5)
    parser.add_argument("--temp", type=float, default=0.5)
    parser.add_argument("--perturb_camera", action="store_true")
    parser.add_argument("--perturb_camera_no_opt", action="store_true")
    parser.add_argument("--perturb_camera_no_detach", action="store_true")
    parser.add_argument("--zero_camera_init", action="store_true")
    parser.add_argument("--rot_epsilon", type=float, default=10)
    parser.add_argument("--trans_epsilon", type=float, default=0.1)
    parser.add_argument("--camera_consistency_loss", type=float, default=0)
    parser.add_argument("--cam_src2tar", type=float, default=0)
    parser.add_argument("--cam_tar2src", type=float, default=0)
    parser.add_argument("--cam_depth", type=float, default=0)
    parser.add_argument("--use_adv_train", action="store_true")
    parser.add_argument("--geo_noise", type=float, default=0)
    parser.add_argument("--use_trans_attack", action="store_true")
    parser.add_argument("--total_view_limit", type=int, default=None)
    # parse-compat only: dead in the reference too — `--attack_mode` is
    # commented out of its parser (reference config.py:154) and
    # `--purif_lr` is read into a variable that is never consumed
    # (reference eval/gnt/eval_adv.py:1074; opt_purif uses adam_lr,
    # :1084). Accepted here so reference command lines carrying them parse.
    parser.add_argument("--attack_mode", type=str, default="view_specific",
                        choices=["view_specific", "image_specific", "no_attack"])

    # ---- purification / defenses (gnt stack, eval/gnt/config.py:291-307)
    parser.add_argument("--use_purification", action="store_true")
    parser.add_argument("--use_self_purification", action="store_true")
    parser.add_argument("--purif_consistency_loss", type=float, default=0)
    parser.add_argument("--purif_lr", type=float, default=2)  # parse-compat (dead, see above)
    parser.add_argument("--purif_epsilon", type=float, default=8)
    parser.add_argument("--purif_iters", type=int, default=100)
    parser.add_argument("--def_random_noise", type=float, default=0)
    parser.add_argument("--run_val", action="store_true")

    # ---- extras without a reference counterpart
    parser.add_argument("--n_devices", type=int, default=None,
                        help="mesh size (default: all available)")
    parser.add_argument("--lpips_weights", type=str, default="",
                        help="path to LPIPS VGG weights (.npz); LPIPS skipped if empty")
    parser.add_argument("--out_dir", type=str, default="out")
    parser.add_argument("--video_fps", type=int, default=30)
    parser.add_argument("--video_frames", type=int, default=120,
                        help="cap on spiral frames to render")
    return parser


def port_parser():
    """``config_parser`` plus the port's own flags."""
    import json

    parser = config_parser()
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--seed", type=int, default=0,
                        help="random weights when --ckpt_path is empty, and "
                             "the attack's random draws")
    parser.add_argument("--max_views", type=int, default=None)
    # fused view-attention kernel (ops/view_attention.py) on the no-grad GNT
    # whole-frame renders that take the module path: auto = on a CUDA
    # device; forward only, never on the attack step. True and False parse
    # as on and off
    parser.add_argument("--gnt_fused_vt", type=on_off_auto, default="auto")
    # whole-frame renders take the per-tap gather unless --use_bspg True: on
    # the H100 it renders the IBRNet view faster than BSPG and the GNT view
    # as fast, and needs no host plan (timed in turns by chip_smoke.py;
    # PERF.md)
    parser.set_defaults(use_bspg=False)
    # pixelNeRF (--backbone pixelnerf; models/pixelnerf.py), defaults from
    # its conf/default_mv.conf: ResnetFC's hidden width and the depth-guided
    # fine samples (its n_fine_depth; the samples drawn from the coarse
    # weights are --N_importance). Its other widths are constants there
    parser.add_argument("--pixelnerf_d_hidden", type=int, default=512)
    parser.add_argument("--pixelnerf_n_depth", type=int, default=16)
    parser.add_argument("--dataset_kwargs", type=json.loads, default={},
                        help="JSON object of dataset constructor keywords")
    return parser
