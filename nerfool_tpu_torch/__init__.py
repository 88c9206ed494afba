"""nerfool_tpu_torch: the PyTorch / CUDA port of nerfool_tpu for NVIDIA Hopper.

The JAX package ``nerfool_tpu`` stays the numerical reference; every module
here mirrors the module of the same path there, keeps its public layouts
(NHWC images and feature maps, views-first ``[V, R, S, C]`` aggregator
operands, 34-float cameras) and imports no JAX. The framework-free
``nerfool_tpu.config`` and ``nerfool_tpu.data`` are reused as they are.

Layout:
  device.py  device resolution
  utils/     camera codec and ray generation
  render/    projection, sampling, compositing, per-ray and whole-frame render
  models/    ResUNet, IBRNet aggregator, model bundle, flax-weight conversion
  ops/       BSPG planner, slot walk and the hand-written CUDA selection kernel
  metrics/   PSNR and SSIM (TF protocol)
  engine.py  clean whole-frame evaluator; eval.py is its command line

Precision is pinned here, at package entry: f32 matrix products and cuDNN
convolutions run in full f32, never TF32. cuDNN's TF32 convolutions would
otherwise move the ResUNet away from the f32 reference by about 1e-3 relative.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
