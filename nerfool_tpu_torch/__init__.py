"""nerfool_tpu_torch: the PyTorch / CUDA port of nerfool_tpu for NVIDIA Hopper.

The JAX package ``nerfool_tpu`` stays the numerical reference; every module
here mirrors the module of the same path there, keeps its public layouts
(NHWC images and feature maps, views-first ``[V, R, S, C]`` aggregator
operands, 34-float cameras). The package imports no JAX and nothing of
``nerfool_tpu``: ``config.py`` and ``data/`` are its own copies of the
framework-free flag parser and numpy loaders there.

Layout:
  device.py  device resolution
  config.py  the command-line flags (same names and defaults as the JAX
             package's), plus the port's own
  data/      numpy dataset loaders, the procedural ``synthetic`` scene
  utils/     camera codec and ray generation
  render/    projection, sampling, compositing, per-ray and whole-frame render
  models/    ResUNet, IBRNet and GNT aggregators, model bundle, flax-weight
             conversion
  ops/       BSPG planner and slot walk, the hand-written CUDA kernels (BSPG
             selection, the whole-chain GNT aggregation, the ray attention
             forward and backward) and their nvcc build
  attack/    perturbation, loss terms and the view-specific attack step
  metrics/   PSNR and SSIM (TF protocol and GNT's windowed protocol)
  engine.py  attack and whole-frame evaluator; eval.py (clean) and
             eval_adv.py (attacked) are its command lines

Precision is pinned here, at package entry: f32 matrix products and cuDNN
convolutions run in full f32, never TF32. cuDNN's TF32 convolutions would
otherwise move the ResUNet away from the f32 reference by about 1e-3 relative.
bf16 matrix products reduce in f32 (no reduced-precision reduction), so a
bf16 product rounds once, at its output, as XLA's bf16 dot does.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

__version__ = "0.1.0"
