#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (``nerfool_tpu_torch``).

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

Phases, each printing a line; any failure raises and exits non-zero:
  1. device: a CUDA card is required (no CPU fallback); prints
     ``nvidia-smi --query-gpu=name,power.limit``
  2. build: compiles ``csrc/bspg_select.cu`` (K1), ``csrc/gnt_chain.cu``
     (K2), ``csrc/ray_attention.cu`` (K3) and ``csrc/view_attention.cu``
     (K4) from the checkout, one nvcc each, started together (sm_90a)
  3. plan: the IBRNet slice's BSPG plan (synthetic scene, 15 views at
     378x504)
  4. kernel vs plain: ``bspg_select`` against its plain PyTorch version at the
     IBRNet slice's shapes (rgb and feature tables, f32 and bf16), with
     timings
  5. cross-device: one small-scene view rendered on the CPU (plain
     selection) and on the card (kernel) with the same weights
  6. the IBRNet slice: ``Evaluator.evaluate`` (the code ``python -m
     nerfool_tpu_torch.eval`` runs) renders 2 test views whole-frame with
     IBRNet at full width (random seeded weights) through BSPG, after one
     warm-up render whose outputs are checked finite; K1's launch count
     must grow by tables x levels x chunks x views; then one view in turns
     through BSPG and the per-tap gather (BSPG, per-tap, per-tap, BSPG)
  7. K2 vs plain: ``gnt_chain`` against ``gnt_chain_plain`` at the GNT
     slice's shapes (10 views, 192 samples, depth 8), with samples masked in
     every view among the inputs: f32 on 512 rays to a tight bound; bf16
     (the tensor-core kernel) on 512 rays, on a whole 4096-ray chunk and on
     the frame's shorter last chunk, to a bound derived from the plain bf16
     chain's own error; CUDA-event timings of both, at the chunk in turns
     (kernel, plain, plain, kernel); the kernel's registers, spills, shared
     memory and resident blocks
  8. GNT cross-device: a small-scene bf16 GNT view rendered on the card
     (K1 + K2) against the CPU's plain bf16 render of the same weights, in
     max and mean abs, to a bound derived from a second card render through
     the module path (see gnt_cross_device)
  9. the GNT slice: planned (4x4 blocks), ``bspg_select`` against its plain
     version at the GNT slice's shapes (bf16 and f32 tables), then
     ``Evaluator.evaluate`` renders 2 test views whole-frame with
     ``configs/gnt/gnt_full.txt`` (depth 8, 192 samples, single_net,
     ret_alpha) in bf16 at 378x504 (render_stride 2), 10 source views,
     through K1 and K2, after one warm-up render; K2's launch count must
     equal chunks x levels x views and K1's tables x levels x chunks x views;
     then one view in turns through K2 and through the bf16 module path
     (``--gnt_fused_chain`` on, off, off, on), rays/s of each, the same
     view in turns through BSPG and per tap, and once more through K2
     under ``torch.profiler`` (device time by kernel)
 10. K3 vs plain: the ray-attention kernels, forward and backward, through
     their ``autograd.Function`` against ``ray_attention_plain`` and
     ``ray_attention_bwd_plain`` (out, attn0, dx, dWqkv, dWo, dbo) at the
     attack slice's shape (800 rays, 192 samples, f32), at an odd shape
     (3 rays, 10 samples) and in bf16, under a cotangent that feeds both
     outputs and one that feeds ``out`` only; the forward alone in f32 at
     the two shapes the attacked GNT render gives it (a whole chunk of rays
     and the shorter last chunk); CUDA-event timings of both kernels, both
     plain versions and the unfused module path with autograd, and of the
     forward at the whole chunk too; the forward's bound at the rate each
     part runs at beside the bound with every operation on the CUDA cores,
     and its registers, spills and resident blocks
 11. the GNT attack slice: ``configs/gnt/gnt_full.txt`` in f32, 10 source
     views, ``--view_specific --use_adam --adam_lr 1e-3 --adv_lr 1 --epsilon
     8 --gnt_fused_attack True``: ``Evaluator.attack_view_specific`` on one
     test view, 2 warm-up iterations then 10 timed (K3 forward and backward
     launches must each equal iterations x depth), the constraints on
     ``delta``, one step of the fused route against the unfused module path
     from the same ``delta`` and rays, then the attacked whole-frame render
     with ``--gnt_fused_attn on`` and the default ``--gnt_fused_vt auto``
     (K1 for the taps, K3 forward and K4 launches = chunks x depth) on the
     BSPG plan of phase 9, held against the same render through the unfused
     ray attention (``--gnt_fused_attn off``); then that render in turns
     through K3 and the module path's ray attention (on, off, off, on)
 12. the IBRNet attack: ``configs/ibrnet/eval_llff.txt`` with the same
     attack flags (N_rand 512) on the model and plan of phase 6: 2 warm-up
     iterations then 10 timed, the constraints on ``delta``, then the
     attacked render through BSPG (K1)
 13. K4 vs plain: the view-attention kernel against
     ``view_attention_plain`` in f32 at the shapes the attacked GNT render
     gives it (a whole chunk's 4096 x 192 rows and the last chunk's 3328 x
     192, 10 views), at the attack batch's 800 x 192 rows and at an odd
     shape (3 views, 15 rows), each with a block of rows masked in every
     view; in bf16 against the plain f32 version on the same bf16 inputs;
     CUDA-event timings of kernel and plain version, the bound at the rate
     each part runs at and the bound with every operation on the CUDA cores
 14. the universal slice: ``configs/gnt/gnt_full.txt`` in f32, the 10 views
     of the global source set, ``--use_adam --adam_lr 1e-3 --adv_lr 1
     --epsilon 8 --use_pseudo_gt --use_center_view --gnt_fused_attack True
     --gnt_fused_attn on`` (``--gnt_fused_vt`` at its default, ``auto``)
     and no ``--view_specific``: 2
     warm-up iterations of ``Evaluator.attack_universal``, then
     ``Evaluator.evaluate`` runs 10 timed iterations over streamed
     train-split targets (K3 launches: iterations x depth backward, twice
     that forward, the pseudo ground truth being a second, no-grad render)
     and renders one test view whole-frame from the perturbed global set on
     the BSPG plan of phase 9 (K4 launches = chunks x depth, K3 forward the
     same, K1 tables x chunks); the constraints on ``delta``; the same
     render with ``--gnt_fused_vt False`` must launch no K4 and agree; both
     routes timed in turns in this process
 15. one iteration each, small and untimed, of the universal attack with
     ``--use_pcgrad --depth_var_loss`` (IBRNet) and with ``--perturb_camera``
     (GNT, 48x64): finite losses, the clamps on the camera parameters (read
     back from the attack's checkpoint), and the pose attack's whole-frame
     render on the per-tap route
 16. the defended attack at 378x504: (a) the IBRNet view-specific attack
     with the multi-view-consistency terms under the camera-pose attack
     (``--depth_consistency_loss 0.5 --camera_consistency_loss 0.5
     --cam_src2tar 1 --cam_tar2src 1 --cam_depth 0.1 --perturb_camera``,
     N_rand 512), in turns with phase 12's plain attack (plain, consistency,
     consistency, plain; 2 warm-up and 4 timed iterations each), then with
     ``--ds_rgb``; the constraints on ``delta``, ``rot`` and ``trans``; the
     z-buffered warp of a source view run twice on the card, bit for bit
     equal; (b) the GNT attack of phase 11 (f32, N_rand 800,
     ``--gnt_fused_attack True``), 2 warm-up and 4 timed iterations, then
     ``--use_purification --use_self_purification --purif_consistency_loss
     0.1 --purif_iters 4`` and ``--def_random_noise 2``: K3 forward and
     backward launches = (iterations + purification steps) x depth; then the
     defended sources' attacked frame as hybrids, ``--use_clean_density``
     and ``--use_clean_color`` with ``--gnt_fused_attn on`` (per-tap route:
     K3 forward and K4 launches = chunks x depth x both branches)
 17. the evaluator's outputs: random LPIPS weights written with the port's
     ``save_lpips_weights``; one clean view per backbone (IBRNet at
     378x504 on phase 6's plan, GNT in bf16 at render_stride 2 on phase 9's)
     through ``Evaluator.evaluate`` with ``--lpips_weights`` and
     ``--export_adv_source_img`` into a temporary directory: finite LPIPS
     per level, equal to a recompute on the card and within rtol 1e-4 of the
     CPU's LPIPS of the same frame, its ms per frame; the exact file set of
     the dumps, each PNG's IHDR (width, height, bit depth, colour type)
     against its array; K1 against its plain version at the IBRNet slice's
     bf16 table shapes, both levels; the IBRNet view-specific attack and the
     GNT attack with ``--feature_dtype bfloat16`` in turns with f32 features
     (f32, bf16, bf16, f32; 2 warm-up and 4 timed iterations), delta inside
     its bounds, K3 launches = iterations x depth; the IBRNet frame with
     ``--compute_dtype bfloat16`` in turns with f32 on BSPG (K1 on bf16
     tables, launches = tables x levels x chunks) and per tap, rays/s, the
     BSPG bf16 frame's coarse rgb no farther from the f32 frame than twice
     the per-tap bf16 frame is
 18. training through ``python -m nerfool_tpu_torch.train``'s ``main`` on
     the synthetic train split at 378x504, 10 source views, f32, random
     weights, 2 warm-up and 10 timed steps each (ms per step, losses, peak
     device memory): (a) IBRNet at ``configs/ibrnet/pretrain.txt``'s widths
     (64 + 64 samples, inv_uniform, N_rand 320): every parameter group
     moved and every value finite, the final checkpoint reloaded through
     ``create_model`` with equal tensors, one ``i_img`` panel set (file
     names, PNG headers); (b) the same with ``--use_adv_train --adv_iters
     3``: the inner delta inside the eps-ball and the image box; (c) GNT at
     ``configs/gnt/gnt_full.txt``'s widths (depth 8, 192 samples, N_rand
     800, single_net) with ``--gnt_fused_attn on``: K3 forward, backward and
     backward-with-weight-gradient launches = steps x depth, one step's
     every parameter gradient through K3 against the module path's from the
     same draws (the limbs of phase 11's step check), then steps of the
     two routes in turns (K3, module, module, K3); two more steps of IBRNet
     and of GNT (through K3) under ``torch.profiler``
 19. the ray split, the video and the sweep: (a) two processes on the one
     card in a gloo group (NCCL refuses two ranks on one device; gloo
     carries CUDA tensors for all-reduce), each running this script with
     ``--split-rank``: the GNT attack evaluator of phase 11 finds the
     group; one view-specific attack step (f32, N_rand 800, through K3)
     split over the ranks (the feature net on each rank's source views,
     the rays by rank) against the one-process step with the feature net
     in the same view batches, from the same delta and rays (the limbs of
     phase 11's step check), the feature net's batch effect against
     float64 (``feature_batches``), the views each rank's feature net
     took, each rank's peak memory and the two-rank factor, the same for
     IBRNet's attack step (N_rand 512), the feature maps' gathers timed
     alone, the attacked
     whole-frame GNT render (K1, K3, K4 on the plan of phase 9) split by
     chunks against the one-process frame, one GNT train step through K3
     with dW (each rank its own view and draws) against the one-process
     step with the ranks' gradients averaged (phase 18's limbs), K1's, K3's
     and K4's launches per rank, and each route's time; (b) ``python -m
     nerfool_tpu_torch.train --distributed`` in a world of one rank under
     NCCL, 2 steps at pretrain.txt's widths, against the run without the
     flag; (c) ``python -m nerfool_tpu_torch.render_video``, 2 spiral
     frames of a 378x504 fixture LLFF scene (``verify_parity.make_fixture``,
     read back by the port's PNG reader): GNT at gnt_full.txt's widths in
     bf16 through K2 (launches = chunks x frames) and IBRNet per tap, the
     PNG headers, s/frame, and the PNG reader's seconds on one LLFF frame
     of ``images_4``'s size (756x1008 RGB, rows in all five filters); (d) ``python -m nerfool_tpu_torch.sweep`` over
     the synthetic scene (IBRNet, 2 attack iterations on 2 views): the
     report's keys, finite rows, s/scene
 20. K5 (``csrc/conv2d.cu``, the feature net's convolutions) at the
     attack's shapes, 10 views at 756x1008: every distinct convolution's
     forward and input gradient against float64 beside the library's (cuDNN,
     f32, TF32 off), their ms in turns with the library's and the plain
     version's, summed beside the bound; the whole feature net (IBRNet's and
     GNT's heads) against float64 through both routes, its 35 + 35 launches
     and its ms through both routes in turns. Alone: ``python3
     chip_smoke.py --conv-only`` (~2 min)
 21. K6 (``csrc/linear.cu``, pixelNeRF's ResnetFC products) at the
     pixelNeRF attack cell's shapes (10 sources, 512 rays, 64 and 96
     samples, 512 wide): lin_z on the coarse taps, fc_1 on the fine rows,
     fc_0's and lin_z's input gradients, each against float64 beside
     cuBLAS's f32 (no more than twice its error), their ms in turns with the
     plain version's and ``torch.matmul``'s beside the bound; the pixelNeRF
     attack on the synthetic slice through K6 and the module's layers in
     turns (26 + 26 launches an iteration, held), a frame through
     ``Evaluator.render_view`` at render_stride 4 (26 forward launches a
     chunk, held), three pixelNeRF training steps through the trainer's
     entry point (26 + 26 launches a step, held) and ResnetFC's every
     gradient against float64. Alone: ``python3 chip_smoke.py
     --dense-only`` (~2 min)
K5's launches are held on the main paths' own runs above, where each is
counted: 35 forward and 35 input-gradient launches an attack iteration or
purification step, 35 forward a whole frame, 35 forward and 34 input
gradient a training step (the images want no gradient), none with bf16
features.
Then the card line, a JSON line of kernel results (for each kernel its
launches on the main paths, its error and time against its plain version,
and the least time the card could take for the same work), and as the last
line ``{"ok": true, "device": {...}}``.
"""
import contextlib
import json
import math
import os
import struct
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# the slice: configs/ibrnet/eval_llff.txt at full model width, random
# weights, on the procedural synthetic scene at half the flagship's 756x1008.
# 15 views hold out 4 test views and leave 11 train views, of which the
# nearest-view selection takes 10 (it never takes all of them)
SLICE_ARGV = ["--config", os.path.join(ROOT, "configs/ibrnet/eval_llff.txt"),
              "--eval_dataset", "synthetic", "--eval_scenes", "synthetic",
              "--ckpt_path", "", "--num_source_views", "10",
              "--chunk_size", "4096", "--use_bspg", "True"]
SLICE_DATA = {"n_views": 15, "h": 378, "w": 504}
SLICE_VIEWS = 2
# small scene for the CPU-vs-card check: the fixture the planner accepts
SMALL_ARGV = ["--eval_dataset", "synthetic", "--ckpt_path", "",
              "--num_source_views", "4", "--N_samples", "64",
              "--N_importance", "64", "--inv_uniform", "--chunk_size", "1024",
              "--use_bspg", "True"]
SMALL_DATA = {"n_views": 6, "h": 48, "w": 64}

# the GNT slice: configs/gnt/gnt_full.txt (depth 8, netwidth 64, 192 samples,
# N_importance 0, single_net, ret_alpha, render_stride 2) in bf16 on the same
# scene, random weights, on the BSPG route. Chunk 4096 replaces the config's
# 800 (fewer, larger launches; every GNT number in PERF.md is at 4096). The
# planner rejects 8x8 blocks at stride 2 on this scene (the rgb tube radius,
# 47 px, exceeds the largest patch, 32;
# tests/test_torch_gnt.py::test_slice_rig_rejects_8x8_blocks_at_stride_2
# shows it for the JAX planner and the port's), so the slice plans 4x4
# blocks: 189x252 rays, padded to 192x252, in 12 chunks
GNT_ARGV = ["--config", os.path.join(ROOT, "configs/gnt/gnt_full.txt"),
            "--eval_dataset", "synthetic", "--eval_scenes", "synthetic",
            "--ckpt_path", "", "--num_source_views", "10",
            "--chunk_size", "4096", "--compute_dtype", "bfloat16",
            "--bspg_block", "4", "--use_bspg", "True"]
GNT_VIEWS = 2
CHAIN_RAYS = 512  # K2 vs plain in f32 and bf16 on a subset of a chunk's rays
CHAIN_PIECE = 1024  # rays per call of the f32 plain chain (its memory)
# small GNT scene for the CPU-vs-card check (depth 8, fewer samples)
GNT_SMALL_ARGV = ["--config", os.path.join(ROOT, "configs/gnt/gnt_full.txt"),
                  "--eval_dataset", "synthetic", "--eval_scenes",
                  "synthetic", "--ckpt_path", "", "--num_source_views", "4",
                  "--N_samples", "32", "--render_stride", "1",
                  "--chunk_size", "1024", "--use_bspg", "True"]

# the attack slices: the flagship attack (README: --view_specific --use_adam
# --adam_lr 1e-3 --adv_lr 1 --epsilon 8), a few iterations of its 1000
ATTACK_FLAGS = ["--view_specific", "--use_adam", "--adam_lr", "1e-3",
                "--adv_lr", "1", "--epsilon", "8"]
ATTACK_WARMUP, ATTACK_ITERS = 2, 10
# the defended attack (phase 16): the consistency terms under the pose
# attack on IBRNet, purification and the noise defense on GNT, then hybrid
# frames; hybrid renders bypass BSPG, so those evaluators plan nothing
CONS_FLAGS = ["--depth_consistency_loss", "0.5", "--camera_consistency_loss",
              "0.5", "--cam_src2tar", "1", "--cam_tar2src", "1",
              "--cam_depth", "0.1", "--perturb_camera"]
DEFENSE_FLAGS = ["--use_purification", "--use_self_purification",
                 "--purif_consistency_loss", "0.1", "--def_random_noise", "2",
                 "--use_bspg", "False"]
DEF_WARMUP, DEF_ITERS, PURIF_ITERS = 2, 4, 4
# GNT in f32 (attacks run in f32), N_rand 800 from the config, the fused ray
# attention on the differentiated step and on the attacked render
GNT_ATTACK_ARGV = [a for a in GNT_ARGV if a not in ("--compute_dtype",
                                                    "bfloat16")] + [
    *ATTACK_FLAGS, "--gnt_fused_attack", "True", "--gnt_fused_attn", "on"]
IBR_ATTACK_ARGV = SLICE_ARGV + ATTACK_FLAGS
RA_SHAPE = (800, 192)  # K3 at the attack slice's shape: N_rand x N_samples
RA_ODD_SHAPE = (3, 10)
# the universal slice: the README's universal attack (one delta on the global
# source set, pseudo ground truth, no --view_specific) on GNT in f32, the
# attacked render through K1, K4 and K3
UNIVERSAL_FLAGS = ["--use_adam", "--adam_lr", "1e-3", "--adv_lr", "1",
                   "--epsilon", "8", "--use_pseudo_gt", "--use_center_view"]
UNI_ARGV = [a for a in GNT_ARGV if a not in ("--compute_dtype", "bfloat16")] \
    + [*UNIVERSAL_FLAGS, "--gnt_fused_attack", "True", "--gnt_fused_attn",
       "on"]
VA_ODD_SHAPE = (3, 15)  # views, rows
VA_MASKED_ROWS = 100  # rows masked in every view (5 at the odd shape)
# the training phase (18): the port's trainer through its entry point on the
# synthetic train split at 378x504 with 10 source views, f32, random weights:
# IBRNet at configs/ibrnet/pretrain.txt's widths (64 + 64 samples,
# inv_uniform, N_rand 320, lrates 1e-3 and 5e-4), plain and adversarial
# (--adv_iters 3, the trainer's default: the reference flag's 100 do not fit
# the phase), then GNT at configs/gnt/gnt_full.txt's (depth 8, 192 samples,
# N_rand 800, single_net) with the ray attention through K3, forward and
# backward with the weight gradients
TRAIN_WARMUP, TRAIN_STEPS = 2, 10
TRAIN_TURN_STEPS = 5  # steps per turn of the route A/B, the first untimed
TRAIN_COMMON = ["--train_dataset", "synthetic", "--ckpt_path", "",
                "--num_source_views", "10", "--workers", "2",
                "--dataset_kwargs", json.dumps(SLICE_DATA), "--i_print", "1",
                "--i_weights", "1000000", "--no_reload",
                "--n_iters", str(TRAIN_WARMUP + TRAIN_STEPS)]
IBR_TRAIN_ARGV = ["--config", os.path.join(ROOT, "configs/ibrnet/pretrain.txt"),
                  *TRAIN_COMMON]
GNT_TRAIN_ARGV = ["--config", os.path.join(ROOT, "configs/gnt/gnt_full.txt"),
                  "--gnt_fused_attn", "on", "--i_img", "0", *TRAIN_COMMON]

# phase 19: the ray split on two ranks of one card (gloo: NCCL refuses two
# ranks on one device), GNT at the attack slice's widths, one warm-up then
# SPLIT_ITERS timed iterations (attack) and steps (training) per route; the
# NCCL world of one through the trainer; the video of a fixture LLFF scene
# (VIDEO_VIEWS views, so that 11 train views hold the 10 sources); the
# sweep over the synthetic scene
SPLIT_WORLD = 2
SPLIT_ITERS = 3
SPLIT_TIMEOUT = 600  # seconds for each rank
VIDEO_FRAMES, VIDEO_VIEWS = 2, 12
SWEEP_ITERS, SWEEP_VIEWS = 2, 2
# the NCCL world of one against the plain run: the first step's loss comes
# before any update from the same weights and draws (the forward is
# deterministic: equal to rounding); the second follows one Adam update
# whose backward (grid_sample's atomic adds, cuDNN's weight gradients) sums
# in another order from run to run, which moves Adam's first update only
# where |g| is near its eps: 1e-4 relative
TOL_WORLD1_LOSS = (1e-6, 1e-4)

# published peaks of one H100 SXM (dense): device memory bytes/s, f32 on the
# CUDA cores, TF32 and bf16 on the tensor cores (FLOP/s)
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12}

# f32 tables: kernel and plain differ only in summation order
TOL_F32_ABS = 1e-6
# what K1's checks fill the rest of the [V, R, S, 3 + 32] buffer with
SENTINEL = 7.0
# bf16 tables: both accumulate in f32 and round once to bf16, so they differ
# by at most one bf16 ulp of the output (8 significant bits: 2^-7 relative)
TOL_BF16_REL = 2.0 ** -7
# CPU vs card render: float32 on both (TF32 off); the feature net and
# aggregator round in other orders, which reaches the coarse rgb as ~1e-5
TOL_RGB_ABS = 2e-4
TOL_DEPTH_ABS = 2e-3
# K2 in f32: summation order only (~1e-6 of the output per product; every
# block's LayerNorms re-normalise): 1e-4 of the output scale
TOL_CHAIN_F32_REL = 1e-4
# K2 in bf16, against the plain chain in f32 on the same bf16 inputs and
# weights. The kernel rounds to bf16 the operands of every product (x, the
# LayerNorm outputs, the hidden layers, qp, kp - qp + p, the view-weighted o,
# the ray attention's K, V and probabilities) and its outputs; it keeps in
# f32 every sum, the residual stream q, the LayerNorm statistics, v + p and
# both softmaxes. The plain bf16 chain rounds all of those as well, after
# every op, so the kernel's error may be no larger than the plain chain's
CHAIN_BF16_FACTOR = 1.0
# K3 in f32: the forward's products are three TF32 products each, added
# in f32 every one or two k steps (1.6e-7 of scale from float64 on an H100,
# plain f32 7.9e-8), its softmax online against a two-pass one; the
# backward differs in summation order only: 1e-5 of each tensor's scale
TOL_RA_F32_REL = 1e-5
# K3 in bf16, as K2: against the plain f32 version on the same bf16 inputs
# and bf16-valued weights the kernels, which keep f32 inside and round only
# their outputs, may err no more than the plain bf16 version
RA_BF16_FACTOR = 1.0
# K4 in f32: its products are three TF32 products each (every term to
# ~2^-21 of itself, tests/test_torch_kernels.py emulates the split at the
# slice's widths), summed in another order than cuBLAS's, and an online
# softmax over the views against a two-pass one: 1e-5 of the output's scale
TOL_VA_F32_REL = 1e-5
# K4 in bf16, as K2 and K3: against the plain f32 version on the same bf16
# inputs and bf16-valued weights the kernel, which keeps f32 inside but for
# the output product's operand and rounds its output, may err no more than
# the plain bf16 version, which rounds after every operation
VA_BF16_FACTOR = 1.0
# the fused attack step against the unfused module path, one step from the
# same delta and rays: the bounds of tests/test_ra_vjp.py, loss 1e-5
# relative and the delta update 2e-5. The two routes differ in the ray
# attention's rounding only (~1e-7 relative with the FMA forward, ~2e-7
# with the tensor-core one, whose tensor-core additions are flushed to f32
# every few k steps: without that, 3.3e-7 brought the share to 0.99908 in
# one run on an H100 and to 0.998996, below the bound, in another), which
# the ResUNet's deep
# InstanceNorm backward spreads over delta's gradient g as absolute noise
# (measured on an H100 at the slice's size: max 0.5-1.9e-8 = 0.5-1.8e-4 of
# the largest entry, rms 2.5-2.8e-10 against g's rms of 4.7e-6). Adam's
# first step is lr * g / (|g| + 1e-8): where |g| is near 1e-8 that noise
# becomes a step of up to lr, so the update is ill conditioned there and the
# routes are compared on g itself (read from Adam's first moment):
# - at every entry to 1e-3 of g's largest entry; over all entries to 1e-3 in
#   relative L2 (5.2-7.9e-5 measured) and a cosine of 0.9999;
# - over the entries with |g| <= STEP_GRAD_FLOOR (100 x Adam's eps; 28-29%
#   of them, at most half may be) to 1e-2 in relative L2 of that subset
#   (3.4-4.8e-4 measured): a fault confined to small gradients fails here;
# - the update to 2e-5 wherever |g| exceeds the floor (1e-7 measured), and
#   at least 0.999 of ALL entries within 2e-5 (0.9998-0.99993 measured;
#   0.99971 with the tensor-core forward)
TOL_STEP_LOSS_REL = 1e-5
TOL_STEP_DELTA_ABS = 2e-5
STEP_GRAD_FLOOR = 1e-6
STEP_FLOOR_SHARE = 0.5
TOL_STEP_SHARE = 0.999
TOL_STEP_GRAD_REL = 1e-3
TOL_STEP_GRAD_L2 = 1e-3
TOL_STEP_SMALL_GRAD_L2 = 1e-2
TOL_STEP_GRAD_COS = 0.9999
# the split attack step runs the f32 feature net on each rank's share of the
# source views; cuDNN may take another algorithm for a batch of 5 views
# than for 10, so the split is held at the limbs above against one process
# with the feature net in the same batches (the split's own arithmetic),
# and the feature net's maps and input gradient in the ranks' batches may
# sit at most this multiple of the whole batch's distance from float64
# (measured on the card in the same run), each reading at least the floor
TOL_FEATURE_BATCH = 2.0
TOL_FEATURE_BATCH_FLOOR = 2 ** -23  # two roundings of an f32 output
# a parameter tensor of the GNT training step whose gradient is zero in
# exact arithmetic carries f32 rounding noise alone: 4e-14 to 2e-11 of the
# step's largest gradient entry, measured on an H100 at the phase's size,
# where the least tensor with a gradient reached 7.5e-8 of it (see
# train_step_limbs)
TRAIN_GRAD_NOISE = 1e-8
# the attacked f32 GNT render with the fused ray attention against the same
# render through the unfused module path, on the card: the ray attention's
# rounding only (with the FMA forward: rgb 4.2e-7, depth 7.2e-7 at depths
# of 2-6, compositing weights 3.3e-9; with the tensor-core forward on an
# H100: rgb 2.0e-6, depth 1.7e-6, weights 4.7e-9)
TOL_FUSED_RENDER = {"rgb": 1e-5, "depth": 2e-5, "weights": 1e-6}
# the attacked f32 GNT render with the view-attention kernel against the
# same render with the module's view attention (both with the fused ray
# attention), on the card: summation order in the view attention only, which
# the 8 blocks' LayerNorms keep near one rounding: the same bounds
TOL_VT_RENDER = TOL_FUSED_RENDER
# GNT bf16 renders: the card's K2 render may sit at most this multiple of
# the plain bf16 path's own card-to-CPU spread from the CPU render (see
# gnt_cross_device); the K2 render rounds less than the plain path, so its
# spread should be no larger, and 2x leaves room for the rounding orders
GNT_RENDER_FACTOR = 2.0
# LPIPS on the card against the CPU's LPIPS of the same frame: two float32
# VGG16s (TF32 off) that differ in the convolutions' summation order only,
# as the CPU port and the JAX package differ; tests/test_torch_lpips.py holds
# those two at rtol 1e-4, so the card is held at the same
TOL_LPIPS_REL = 1e-4
# IBRNet in bf16 (phase 17): the BSPG frame (K1 on bf16 tables) against the
# f32 frame may sit at most this multiple of the per-tap bf16 frame's own
# distance from its f32 frame: both round the aggregator's inputs and
# weights to bf16; BSPG interpolates bf16 texels where per tap rounds the
# interpolated value, which moves the error's pattern, not its scale
# (tests/test_torch_bf16.py holds both routes to JAX's bf16 render so)
IBR_BF16_FACTOR = 2.0


def log(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def card_line():
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0].strip()


def time_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def taps_operands(v, b, n, s, ks, p, h, w, pby, pbx, c, dtype, seed):
    """K1 operands on the card at one path's shapes: a packed table of V
    views; one group of all V views with slot lists of distinct patch ids
    and -1 pads, as a plan's walk gives them (repeated ids, which the
    contract counts, are in the CUDA tests of tests/test_torch_kernels.py);
    normalized coordinates [V, B, n, S] of which half fall in a patch of
    their row's slots and the rest anywhere in [-1.15, 1.15] (past the
    image's edges too)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rnd = lambda *shape: torch.rand(*shape, device=dev, generator=gen)
    ri = lambda hi, *shape: torch.randint(0, hi, shape, device=dev,
                                          generator=gen)
    table = rnd(v, pby * pbx, (p + 1) ** 2 * c).to(dtype)
    slots = torch.argsort(rnd(v, b, max(ks, pby * pbx)), dim=-1)[..., :ks]
    slots = torch.where(slots < pby * pbx, slots, -1).to(torch.int32)
    slots[..., -2:] = -1
    ns = n * s
    pick = torch.gather(slots, 2, ri(ks - 2, v, b, ns)).long()
    # base cell cb = floor(x) + 1 of a coordinate x; patch q holds cells
    # [q p, q p + p)
    cbx = torch.clamp((pick % pbx) * p + ri(p, v, b, ns), max=w)
    cby = torch.clamp((pick // pbx) * p + ri(p, v, b, ns), max=h)
    inside = rnd(v, b, ns) < 0.5
    gx = torch.where(inside, 2.0 * (cbx - 1 + rnd(v, b, ns)) / (w - 1) - 1.0,
                     2.3 * rnd(v, b, ns) - 1.15)
    gy = torch.where(inside, 2.0 * (cby - 1 + rnd(v, b, ns)) / (h - 1) - 1.0,
                     2.3 * rnd(v, b, ns) - 1.15)
    return (table, slots, tuple(range(v)), gx.reshape(v, b, n, s).float(),
            gy.reshape(v, b, n, s).float())


def chain_operands(net, v, r, s, seed):
    """K2 operands on the card at the given shapes: rgb in [0, 1], features
    ~ N(0, 1), ray differences with their dot near 1, ~10% of the views
    masked, ray 1 and four samples of every 97th ray masked in every view,
    points and directions ~ N(0, 1)."""
    import torch
    from nerfool_tpu_torch.ops import chain

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    rgb_feat = torch.cat([
        torch.rand(v, r, s, 3, device=dev, generator=g),
        torch.randn(v, r, s, 32, device=dev, generator=g)], dim=-1)
    rd = 0.1 * torch.randn(v, r, s, 4, device=dev, generator=g)
    rd[..., 3] = 1.0 - rd[..., 3].abs()
    mask = (torch.rand(v, r, s, 1, device=dev, generator=g) > 0.1).float()
    mask[:, 1] = 0.0
    mask[:, ::97, 5:9] = 0.0
    return chain.chain_inputs(
        net, rgb_feat, rd, mask, torch.randn(r, s, 3, device=dev, generator=g),
        torch.randn(r, 3, device=dev, generator=g))


def rounded(net, dtype):
    """A copy of ``net`` whose weights hold exactly their ``dtype`` values,
    in float32: the f32 reference on the weights a ``dtype`` run uses."""
    import copy
    import torch

    out = copy.deepcopy(net)
    with torch.no_grad():
        for p in out.parameters():
            p.copy_(p.to(dtype).float())
    return out


def check_chain(net, v, s, card, chunk_rays):
    """Phase 7: K2 against its plain version (``GNTAggregator.chain``) at
    the GNT slice's shapes; bf16 at CHAIN_RAYS and at ``chunk_rays`` (a
    whole chunk and the frame's last one)."""
    import torch

    net_b = rounded(net, torch.bfloat16)
    with torch.inference_mode():
        return _check_chain(net, net_b, v, s, card,
                            [CHAIN_RAYS, *chunk_rays])


def _check_chain(net, net_b, v, s, card, chain_rays):
    import torch
    from nerfool_tpu_torch.ops import chain

    depth = net.trans_depth
    merged, emb = chain_operands(net, v, CHAIN_RAYS, s, seed=7)
    rows = []
    # f32: tight
    got = chain.gnt_chain(net, merged, emb)
    torch.cuda.synchronize()
    ref = chain.gnt_chain_plain(net, merged, emb)
    errs = [float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref)]
    tols = [TOL_CHAIN_F32_REL * max(1.0, float(b.abs().max())) for b in ref]
    ms = time_ms(lambda: chain.gnt_chain(net, merged, emb), 3)
    plain_ms = time_ms(lambda: chain.gnt_chain_plain(net, merged, emb), 3)
    rows.append(dict(dtype="f32", rays=CHAIN_RAYS, views=v, samples=s,
                     depth=depth, max_abs_err=max(errs),
                     q_err=errs[0], attn0_err=errs[1], q_tol=tols[0],
                     attn0_tol=tols[1], ms=ms, plain_ms=plain_ms))
    log("K2", f"f32 [V={v} R={CHAIN_RAYS} S={s} depth {depth}]: q max abs "
        f"err {errs[0]:.3g} (tol {tols[0]:.3g}), attn0 {errs[1]:.3g} (tol "
        f"{tols[1]:.3g}); kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; {card}")
    if not (errs[0] <= tols[0] and errs[1] <= tols[1]
            and all(bool(torch.isfinite(t).all()) for t in got)):
        raise AssertionError(f"gnt_chain f32 disagrees with its plain "
                             f"version: {rows[-1]}")
    del got, ref, merged, emb
    res = chain.bf16_kernel_resources(v, s, net.rgbfeat_fc[0].in_features)
    log("K2", f"bf16 kernel: {res['registers']} registers x {res['threads']} "
        f"threads, {res['spill_bytes']} bytes of local memory per thread, "
        f"{res['smem_bytes']} bytes of shared memory per block, "
        f"{res['blocks']} blocks resident on the card")
    # bf16 (the route): kernel and plain bf16 against plain f32 on the same
    # bf16 inputs and bf16-valued weights, at 512 rays, at a whole chunk and
    # at the frame's last chunk
    for seed, rays in enumerate(chain_rays, start=7):
        mb, eb = (t.bfloat16() for t in chain_operands(net, v, rays, s, seed))
        ref = [torch.cat(parts) for parts in zip(*(
            chain.gnt_chain_plain(net_b, mb[:, i:i + CHAIN_PIECE].float(),
                                  eb[i:i + CHAIN_PIECE].float())
            for i in range(0, rays, CHAIN_PIECE)))]
        got = chain.gnt_chain(net, mb, eb)
        plain = chain.gnt_chain_plain(net, mb, eb)
        torch.cuda.synchronize()
        err_k = [float((a.float() - b).abs().max()) for a, b in zip(got, ref)]
        err_p = [float((a.float() - b).abs().max()) for a, b in zip(plain, ref)]
        finite = all(bool(torch.isfinite(t).all()) for t in got)
        del got, ref, plain
        # in turns: kernel, plain, plain, kernel
        k_fn = lambda: chain.gnt_chain(net, mb, eb)
        p_fn = lambda: chain.gnt_chain_plain(net, mb, eb)
        turns = [time_ms(fn, 3) for fn in (k_fn, p_fn, p_fn, k_fn)]
        ms, plain_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
        rows.append(dict(dtype="bf16", rays=rays, views=v, samples=s,
                         depth=depth, max_abs_err=max(err_k),
                         q_err=err_k[0], attn0_err=err_k[1],
                         plain_q_err=err_p[0], plain_attn0_err=err_p[1],
                         factor=CHAIN_BF16_FACTOR, ms=ms, plain_ms=plain_ms,
                         turns_ms=turns, **res))
        log("K2", f"bf16 [V={v} R={rays} S={s}]: vs f32 plain, kernel q err "
            f"{err_k[0]:.3g} / attn0 {err_k[1]:.3g}, plain bf16 q err "
            f"{err_p[0]:.3g} / attn0 {err_p[1]:.3g} (bound: kernel <= "
            f"{CHAIN_BF16_FACTOR:g} x plain); in turns kernel {turns[0]:.3f}, "
            f"plain {turns[1]:.3f}, plain {turns[2]:.3f}, kernel "
            f"{turns[3]:.3f} ms; {card}")
        if not (finite and all(k <= CHAIN_BF16_FACTOR * p
                               for k, p in zip(err_k, err_p))):
            raise AssertionError(f"gnt_chain bf16 outside its bound: "
                                 f"{rows[-1]}")
        del mb, eb
        torch.cuda.empty_cache()
    return rows


def check_select(shapes, path, seed, card):
    """K1 against its plain version at one path's shapes, each a dict of
    (table, level, dtype, V, B, n, S, Ks, p, h, w, pby, pbx, c). The kernel
    writes the taps at the render's channel offset (rgb at 0, the features
    at 3) into a [V, B*n, S, 3 + 32] buffer of SENTINEL, as the render
    path does; the plain version is the G-based contract (``select_plain``:
    the patch rows gathered per slot, the one-hot einsum). Every other
    channel must keep SENTINEL. Returns the rows."""
    import torch
    from nerfool_tpu_torch.ops import bspg_select

    rows = []
    for i, sh in enumerate(shapes):
        v, b, n, s, ks, p, h, w, pby, pbx, c = (sh[k] for k in (
            "V", "B", "n", "S", "Ks", "p", "h", "w", "pby", "pbx", "c"))
        dtype = sh["dtype"]
        table, slots, views, gx, gy = taps_operands(
            v, b, n, s, ks, p, h, w, pby, pbx, c, dtype, seed=seed + i)
        off = 3 if c == 32 else 0
        out = torch.full((v, b * n, s, 35), SENTINEL, dtype=dtype,
                         device="cuda")
        fn = lambda o: bspg_select.select_taps(table, slots, views, gx, gy,
                                               o, off, p, h, w, pbx)
        fn(out)
        torch.cuda.synchronize()
        vi = torch.arange(v, device="cuda")
        plain = lambda: bspg_select.select_plain(table, slots, vi, gx, gy, p,
                                                 h, w, pbx)
        ref = plain().float()
        got = out.view(v, b, n * s, 35).float()
        err = (got[..., off:off + c] - ref).abs()
        scale = torch.maximum(got[..., off:off + c].abs(), ref.abs())
        keep = torch.ones(35, dtype=torch.bool, device="cuda")
        keep[off:off + c] = False
        untouched = bool((got[..., keep] == SENTINEL).all())
        if dtype == torch.float32:
            ok = bool((err <= TOL_F32_ABS).all())
            tol = f"abs {TOL_F32_ABS:g}"
        else:
            ok = bool((err <= TOL_BF16_REL * scale + TOL_F32_ABS).all())
            tol = f"rel {TOL_BF16_REL:g} of |out|"
        rel = float((err / scale.clamp_min(1e-6)).max())
        del ref, got, scale
        ms = time_ms(lambda: fn(out), 20)
        plain_ms = time_ms(plain, 3)
        dt = "f32" if dtype == torch.float32 else "bf16"
        row = dict(path=path, table=sh["table"], level=sh["level"], dtype=dt,
                   views=v, blocks=b, n_rv=v * b, ks=ks, p=p, c=c, ns=n * s,
                   n_patch=pby * pbx, max_abs_err=float(err.max()),
                   max_rel_err=rel, neighbours_untouched=untouched, ms=ms,
                   plain_ms=plain_ms)
        (row["bound_ms"], row["bound_by"]), (row["bound_old_ms"], _) = \
            select_bound(row), select_bound_g(row)
        rows.append(row)
        log("kernel", f"{path} {sh['table']}/{sh['level']}/{dt} [V={v} B={b} "
            f"Ks={ks} p={p} c={c} ns={n * s}]: max abs err "
            f"{row['max_abs_err']:.3g}, max rel {rel:.3g} (tol {tol}); other "
            f"channels untouched: {untouched}; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms; bound {row['bound_ms']:.3f} ms by "
            f"{row['bound_by']} (G-based contract {row['bound_old_ms']:.3f} "
            f"ms); {card}")
        if not (ok and untouched):
            raise AssertionError(f"bspg_select disagrees with its plain "
                                 f"version: {row}")
        del table, slots, gx, gy, out, err
        torch.cuda.empty_cache()
    return rows


def select_shapes(spec, c, table, levels, dtypes, views, chunk):
    """check_select's shape dicts of one table of a BSPG plan: the chunk's
    blocks of every view, ``levels`` (name, samples) and ``dtypes``."""
    bh, bw = spec.block
    ks = max(spec.k_slots(k) for _, k in spec.groups)
    return [dict(table=table, level=level, dtype=dtype, V=views,
                 B=chunk // (bh * bw), n=bh * bw, S=s, Ks=ks, p=spec.p,
                 h=spec.h, w=spec.w, pby=spec.pby, pbx=spec.pbx, c=c)
            for level, s in levels for dtype in dtypes]


def gnt_cross_device(card):
    """Phase 8: a small-scene bf16 GNT view rendered on the card through K1
    and K2 (the route) against the CPU's plain bf16 render (plain selection,
    plain chain) of the same weights. The bound comes from a second card
    render through K1 and the module path (bf16 cuBLAS products, rounded at
    every op as the CPU's are): it shares every input with the K2 render
    (bf16 sample points, features, selection), so its distance to the CPU
    render is the plain bf16 path's own cross-device spread. The K2 render's
    distance to the CPU render may be at most GNT_RENDER_FACTOR times that
    spread, in max and in mean abs. An f32 CPU render is printed for context
    only: the NeRF embeddings of bf16 points (the JAX package computes them
    so too) move every bf16 render far from it."""
    import numpy as np
    import torch
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.eval import parse_args
    from nerfool_tpu_torch.ops import chain

    renders, launches = {}, {}
    for name, dev, dtype, fused in (("f32", "cpu", "float32", "off"),
                                    ("cpu", "cpu", "bfloat16", "on"),
                                    ("card_module", "cuda", "bfloat16", "off"),
                                    ("card", "cuda", "bfloat16", "on")):
        ev = Evaluator(parse_args(GNT_SMALL_ARGV + [
            "--compute_dtype", dtype, "--gnt_fused_chain", fused]),
            dataset_kwargs=SMALL_DATA, device=dev, seed=0)
        data = ev.test_dataset[0]
        before = chain.gnt_chain.launches
        with torch.inference_mode():
            ret = ev.render_view(data, ev._make_src(data))["outputs_coarse"]
        launches[name] = chain.gnt_chain.launches - before
        renders[name] = {k: ret[k].float().cpu().numpy()
                         for k in ("rgb", "depth", "weights")}
    diff = lambda a, b, k: np.abs(renders[a][k] - renders[b][k])
    errs = {k: dict(card_max=float(diff("card", "cpu", k).max()),
                    card_mean=float(diff("card", "cpu", k).mean()),
                    spread_max=float(diff("card_module", "cpu", k).max()),
                    spread_mean=float(diff("card_module", "cpu", k).mean()),
                    bf16_vs_f32_max=float(diff("cpu", "f32", k).max()))
            for k in ("rgb", "depth", "weights")}
    log("GNT cross-device", "; ".join(
        f"{k}: |card K2 - CPU| max {e['card_max']:.3g} mean "
        f"{e['card_mean']:.3g}, |card module - CPU| max {e['spread_max']:.3g}"
        f" mean {e['spread_mean']:.3g}, |CPU bf16 - f32| max "
        f"{e['bf16_vs_f32_max']:.3g}" for k, e in errs.items())
        + f" (bounds: {GNT_RENDER_FACTOR:g}x the module spread); K2 launches "
        f"{launches['card']} (K2 render), {launches['card_module']} (module "
        f"render); {card}")
    ok = (all(np.isfinite(v).all() for v in renders["card"].values())
          and launches["card"] > 0 and launches["card_module"] == 0
          and all(e["card_max"] <= GNT_RENDER_FACTOR * e["spread_max"]
                  and e["card_mean"] <= GNT_RENDER_FACTOR * e["spread_mean"]
                  for e in errs.values()))
    if not ok:
        raise AssertionError(f"card and CPU GNT renders disagree: {errs}, "
                             f"launches {launches}")
    return errs


def bound_ms(n_bytes, flops, dtype):
    """The least time the card could take: each input read and each output
    written once at the memory rate, or the operations at the peak rate of
    their type, whichever is larger. Returns (ms, 'bytes' | 'operations')."""
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    by_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def select_bound(row):
    """K1 at one check's shapes, what it must move: the table once, the slot
    lists, two coordinates per sample in, the taps out; 4 multiply-adds per
    output value."""
    size = 4 if row["dtype"] == "f32" else 2
    v, n_patch, n_rv, ks, p, c, ns = (row[k] for k in (
        "views", "n_patch", "n_rv", "ks", "p", "c", "ns"))
    n_bytes = (v * n_patch * (p + 1) ** 2 * c * size + n_rv * ks * 4
               + n_rv * ns * 2 * 4 + n_rv * ns * c * size)
    return bound_ms(n_bytes, 8 * n_rv * ns * c, row["dtype"])


def select_bound_g(row):
    """The same at the TPU kernels' contract (the first K1's): the patch
    rows G [n_rv, Ks, (p+1)^2 c], the per-sample patch id, two offsets and
    four weights in, the taps out."""
    size = 4 if row["dtype"] == "f32" else 2
    n_rv, ks, p, c, ns = (row[k] for k in ("n_rv", "ks", "p", "c", "ns"))
    n_bytes = (n_rv * ks * (p + 1) ** 2 * c * size + n_rv * ks * 4
               + n_rv * ns * 7 * 4 + n_rv * ns * c * size)
    return bound_ms(n_bytes, 8 * n_rv * ns * c, row["dtype"])


def chain_bound(row, ci=35, d=64, pe=63):
    """K2 at one check's shapes: merged and the embeddings in, q and attn0
    out; the products of the depth blocks by shape."""
    size = 4 if row["dtype"] == "f32" else 2
    v, r, s, depth = (row[k] for k in ("views", "rays", "samples", "depth"))
    per_depth = (2 * d * d + v * 2 * d * 2 * d            # q, kv
                 + v * 2 * (4 * 8 + 8 * d)                # pos MLP
                 + v * 2 * (d * 8 + 8 * d)                # attention MLP
                 + 2 * d * d + 2 * 2 * d * 4 * d          # out_fc, FF
                 + 2 * d * 3 * d + 4 * s * d + 2 * d * d  # ray attention
                 + 2 * 2 * d * 4 * d)                     # FF
    q_fc = 2 * (d + 2 * pe) * d + 2 * d * d               # on even depths
    entry = v * 2 * (ci * d + d * d)
    flops = r * s * (depth * per_depth + -(-depth // 2) * q_fc + entry)
    n_bytes = size * (v * r * s * (ci + 5) + r * s * 2 * pe + r * s * d
                      + r * s)
    return bound_ms(n_bytes, flops, row["dtype"])


def ra_bounds(r, s, dtype, d=64):
    """K3 at [r, s, d]: (forward, backward) bounds with every operation at
    the one peak rate of the dtype (f32: FMA on the CUDA cores, the backward
    kernel's route, and the forward's before it moved onto the tensor
    cores; bf16: the bf16 tensor-core rate). Forward: qkv, scores,
    AV and the output product. Backward: the qkv, score and AV products
    again (nothing is saved) plus two products for each of the four."""
    size = 4 if dtype == "f32" else 2
    fwd = r * s * (2 * d * 3 * d + 4 * s * d + 2 * d * d)
    bwd = 2 * fwd + r * s * (2 * d * 3 * d + 4 * s * d)
    w_bytes = 4 * (d * 3 * d + d * d + d)
    fwd_bytes = size * (2 * r * s * d + r * s) + w_bytes
    bwd_bytes = size * (3 * r * s * d + r * s) + 2 * w_bytes
    return bound_ms(fwd_bytes, fwd, dtype), bound_ms(bwd_bytes, bwd, dtype)


def ra_fwd_bound(r, s, dtype, d=64, n_heads=4):
    """K3's forward at [r, s, d] at the rate each part of its arithmetic
    can run at: the four products on the tensor cores (f32: three TF32
    products each at the TF32 rate; bf16: one at the bf16 rate), the
    softmax (max, subtract, exponent and sum per score and head) at the f32
    rate, the two times added; or x in, out and attn0 written and the
    weights once at the memory rate, whichever is larger."""
    size = 4 if dtype == "f32" else 2
    mma = r * s * (2 * d * 3 * d + 4 * s * d + 2 * d * d)
    soft = r * n_heads * s * s * 4
    if dtype == "f32":
        ops_ms = 3 * mma / PEAK_FLOPS["tf32"] * 1e3
    else:
        ops_ms = mma / PEAK_FLOPS["bf16"] * 1e3
    ops_ms += soft / PEAK_FLOPS["f32"] * 1e3
    n_bytes = size * (2 * r * s * d + r * s) + 4 * (d * 3 * d + d * d + d)
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    return (by_bytes, "bytes") if by_bytes >= ops_ms else (ops_ms,
                                                             "operations")


def ra_bwd_bound(r, s, dtype, want_dw, d=64, n_heads=4):
    """K3's backward at [r, s, d] at the rate each part of its arithmetic
    can run at: its products on the tensor cores (f32: three TF32 products
    each at the TF32 rate; bf16: one at the bf16 rate), the projections q |
    k | v = x Wqkv and go = gout Wo^T, then the scores, p v, dp, dq, dk, dv
    and dx = gqkv Wqkv^T once each, and with ``want_dw`` x^T gqkv and
    concat^T gout; one softmax (max, subtract, exponent and sum) and ds =
    p (dp - delta) / sqrt(hd) (subtract, two multiplies) per score and
    head, at the f32 rate (what the function needs: the kernel's recomputed
    scores are its own cost); the two times added. Or x, gout and gattn0
    in, dx out, the weights (and their gradients) once at the memory rate,
    whichever is larger."""
    size = 4 if dtype == "f32" else 2
    mma = r * s * (14 * d * d + 12 * s * d + (8 * d * d if want_dw else 0))
    soft = r * n_heads * s * s * (4 + 3)
    if dtype == "f32":
        ops_ms = 3 * mma / PEAK_FLOPS["tf32"] * 1e3
    else:
        ops_ms = mma / PEAK_FLOPS["bf16"] * 1e3
    ops_ms += soft / PEAK_FLOPS["f32"] * 1e3
    n_bytes = (size * (3 * r * s * d + r * s)
               + 4 * (d * 3 * d + d * d) * (2 if want_dw else 1))
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    return (by_bytes, "bytes") if by_bytes >= ops_ms else (ops_ms,
                                                             "operations")


def ra_operands(r, s, dtype, seed, d=64):
    """K3 operands on the card: x ~ N(0, 1) as after a LayerNorm, weights
    ~ U(-1/sqrt(d), 1/sqrt(d)) as a Linear's init, cotangents ~ N(0, 1)."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    n = lambda *shape: torch.randn(*shape, device="cuda", generator=g)
    u = lambda *shape: (torch.rand(*shape, device="cuda", generator=g) * 2
                        - 1) / d ** 0.5
    return (n(r, s, d).to(dtype), u(d, 3 * d), u(d, d), u(d),
            n(r, s, d).to(dtype), n(r, s).to(dtype))


def ra_through_function(fn, x, wqkv, wo, bo, gout, gattn0):
    """(out, attn0, dx, dwqkv, dwo, dbo) of ``fn`` under the cotangents
    ``gout`` and ``gattn0`` (None: the cotangent feeds ``out`` only)."""
    import torch

    leaves = [t.clone().requires_grad_() for t in (x, wqkv, wo, bo)]
    out, attn0 = fn(*leaves)
    loss = (out.float() * gout.float()).sum()
    if gattn0 is not None:
        loss = loss + (attn0.float() * gattn0.float()).sum()
    grads = torch.autograd.grad(loss, leaves)
    return tuple(t.detach() for t in (out, attn0, *grads))


RA_NAMES = ("out", "attn0", "dx", "dwqkv", "dwo", "dbo")


def ra_plain(x, wqkv, wo, bo, gout, gattn0):
    """The same six tensors from the two plain versions."""
    import torch
    from nerfool_tpu_torch.ops import ray_attention as ra

    ga = torch.zeros_like(x[..., 0]) if gattn0 is None else gattn0
    return (*ra.ray_attention_plain(x, wqkv, wo, bo),
            *ra.ray_attention_bwd_plain(x, wqkv, wo, gout, ga),
            gout.sum((0, 1), dtype=torch.float32))


def check_ray_attention(card, render_rays):
    """Phase 10: K3 forward and backward against their plain versions;
    ``render_rays``: the ray counts of the attacked render's chunks."""
    import torch
    from nerfool_tpu_torch.models.gnt import RayAttention
    from nerfool_tpu_torch.ops import ray_attention as ra

    rows = []
    for label, (r, s) in (("slice", RA_SHAPE), ("odd", RA_ODD_SHAPE)):
        for both in (True, False):
            ops = ra_operands(r, s, torch.float32, seed=r + both)
            if not both:
                ops = ops[:5] + (None,)
            before = (ra.ray_attention_fwd.launches,
                      ra.ray_attention_bwd.launches)
            got = ra_through_function(ra.ray_attention, *ops)
            torch.cuda.synchronize()
            if (ra.ray_attention_fwd.launches, ra.ray_attention_bwd.launches
                    ) != (before[0] + 1, before[1] + 1):
                raise AssertionError("the Function did not launch both "
                                     "kernels once")
            ref = ra_plain(*ops)
            errs = {n: float((a.float() - b.float()).abs().max())
                    for n, a, b in zip(RA_NAMES, got, ref)}
            tols = {n: TOL_RA_F32_REL * max(1.0, float(b.abs().max()))
                    for n, b in zip(RA_NAMES, ref)}
            # the backward alone without weight gradients, the attacks'
            # route: dx against the plain version
            ga = ops[5] if both else torch.zeros_like(ops[0][..., 0])
            dx = ra.ray_attention_bwd(*ops[:3], ops[4], ga, want_dw=False)[0]
            torch.cuda.synchronize()
            errs["dx_no_dw"] = float((dx - ref[2]).abs().max())
            tols["dx_no_dw"] = tols["dx"]
            rows.append(dict(shape=label, dtype="f32", rays=r, samples=s,
                             cotangent="out+attn0" if both else "out",
                             errs=errs, tols=tols))
            log("K3", f"f32 [R={r} S={s}] cotangent "
                f"{rows[-1]['cotangent']}: max abs err " + ", ".join(
                    f"{n} {errs[n]:.3g} (tol {tols[n]:.3g})"
                    for n in errs) + f"; {card}")
            if not (all(errs[n] <= tols[n] for n in errs) and all(
                    bool(torch.isfinite(t).all()) for t in (*got, dx))):
                raise AssertionError(f"ray_attention f32 disagrees with its "
                                     f"plain versions: {rows[-1]}")
            del got, ref, ops, dx

    # the forward alone at the shapes the attacked f32 render launches it at
    # (no autograd there): far more rays than blocks of the persistent grid
    s = RA_SHAPE[1]
    for r in render_rays:
        x, wqkv, wo, bo = ra_operands(r, s, torch.float32, seed=r)[:4]
        with torch.inference_mode():
            got = ra.ray_attention_fwd(x, wqkv, wo, bo)
            torch.cuda.synchronize()
            ref = ra.ray_attention_plain(x, wqkv, wo, bo)
        errs = {n: float((a - b).abs().max())
                for n, a, b in zip(RA_NAMES, got, ref)}
        tols = {n: TOL_RA_F32_REL * max(1.0, float(b.abs().max()))
                for n, b in zip(RA_NAMES, ref)}
        row = dict(shape="render chunk", dtype="f32", rays=r, samples=s,
                   cotangent=None, errs=errs, tols=tols)
        if r == max(render_rays):
            # the forward's time at the shape of most of its launches in
            # the attacked renders
            row.update(
                ms=time_ms(lambda: ra.ray_attention_fwd(x, wqkv, wo, bo), 20),
                plain_ms=time_ms(lambda: ra.ray_attention_plain(
                    x, wqkv, wo, bo), 5))
            row["bound_ms"], row["bound_by"] = ra_fwd_bound(r, s, "f32")
            row["bound_fma_ms"] = ra_bounds(r, s, "f32")[0][0]
        rows.append(row)
        log("K3", f"f32 [R={r} S={s}] forward only (render chunk): max abs "
            "err " + ", ".join(f"{n} {errs[n]:.3g} (tol {tols[n]:.3g})"
                               for n in errs)
            + (f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms,"
               f" bound {row['bound_ms']:.4f} ms by {row['bound_by']} (all "
               f"f32 FMA on the CUDA cores {row['bound_fma_ms']:.4f} ms)"
               if "ms" in row else "") + f"; {card}")
        if not (all(errs[n] <= tols[n] for n in errs) and all(
                bool(torch.isfinite(t).all()) for t in got)):
            raise AssertionError(f"ray_attention_fwd disagrees with its "
                                 f"plain version: {rows[-1]}")
        del got, ref, x

    # bf16 at the slice's shape: kernel and plain bf16 against plain f32 on
    # the same bf16 inputs and bf16-valued weights
    r, s = RA_SHAPE
    ops = ra_operands(r, s, torch.bfloat16, seed=11)
    f32_ops = tuple(t.bfloat16().float() for t in ops)
    ref = ra_plain(*f32_ops)
    got = ra_through_function(ra.ray_attention, *ops)
    plain = ra_plain(*ops)
    torch.cuda.synchronize()
    err_k = {n: float((a.float() - b).abs().max())
             for n, a, b in zip(RA_NAMES, got, ref)}
    err_p = {n: float((a.float() - b).abs().max())
             for n, a, b in zip(RA_NAMES, plain, ref)}
    rows.append(dict(shape="slice", dtype="bf16", rays=r, samples=s,
                     cotangent="out+attn0", errs=err_k, plain_errs=err_p,
                     factor=RA_BF16_FACTOR))
    log("K3", f"bf16 [R={r} S={s}]: vs f32 plain, kernel / plain bf16 err "
        + ", ".join(f"{n} {err_k[n]:.3g} / {err_p[n]:.3g}" for n in RA_NAMES)
        + f" (bound: kernel <= {RA_BF16_FACTOR:g} x plain); {card}")
    if not all(err_k[n] <= RA_BF16_FACTOR * err_p[n] + 1e-12
               for n in RA_NAMES):
        raise AssertionError(f"ray_attention bf16 outside its bound: "
                             f"{rows[-1]}")
    del got, ref, plain, ops, f32_ops

    # timings at the slice's shape, f32 (the attack's dtype) and bf16
    times = {}
    for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x, wqkv, wo, bo, gout, gattn0 = ra_operands(r, s, dtype, seed=12)
        t = dict(
            fwd_ms=time_ms(lambda: ra.ray_attention_fwd(x, wqkv, wo, bo), 20),
            # the same launch with the weights packed anew each time
            # (ray_attention_fwd packs them once for each value)
            fwd_repack_ms=time_ms(lambda: ra.launch_fwd(
                ra.build(), x, wqkv, wo, bo), 20),
            bwd_ms=time_ms(lambda: ra.ray_attention_bwd(
                x, wqkv, wo, gout, gattn0), 10),
            bwd_no_dw_ms=time_ms(lambda: ra.ray_attention_bwd(
                x, wqkv, wo, gout, gattn0, want_dw=False), 10),
            plain_fwd_ms=time_ms(lambda: ra.ray_attention_plain(
                x, wqkv, wo, bo), 5),
            plain_bwd_ms=time_ms(lambda: ra.ray_attention_bwd_plain(
                x, wqkv, wo, gout, gattn0), 5))
        # the unfused module path, forward and backward through autograd,
        # beside the Function's forward and backward (x differentiated,
        # weights frozen, as in the attack)
        mod = RayAttention(64).cuda().requires_grad_(False)

        def module_step(fused):
            xx = x.clone().requires_grad_()
            out, attn = mod(xx, fused=fused)
            a0 = attn if fused else attn.mean(1)[:, 0]
            loss = (out.float() * gout.float()).sum() + (
                a0.float() * gattn0.float()).sum()
            return torch.autograd.grad(loss, xx)

        t["module_fwd_bwd_ms"] = time_ms(lambda: module_step(False), 5)
        t["fused_fwd_bwd_ms"] = time_ms(lambda: module_step(True), 5)
        (fone, _), (bone, _) = ra_bounds(r, s, dt)
        fb, fby = ra_fwd_bound(r, s, dt)
        bb, bby = ra_bwd_bound(r, s, dt, want_dw=True)
        bn, bny = ra_bwd_bound(r, s, dt, want_dw=False)
        t.update(fwd_bound_ms=fb, fwd_bound_by=fby,
                 fwd_bound_one_rate_ms=fone, bwd_bound_ms=bb, bwd_bound_by=bby,
                 bwd_no_dw_bound_ms=bn, bwd_no_dw_bound_by=bny,
                 bwd_bound_one_rate_ms=bone,
                 fwd_resources=ra.kernel_resources(s, dtype),
                 bwd_resources=ra.kernel_resources(s, dtype, backward=True),
                 bwd_dw_resources=ra.kernel_resources(
                     s, dtype, backward=True, want_dw=True))
        times[dt] = t
        res, bres = t["fwd_resources"], t["bwd_resources"]
        wres = t["bwd_dw_resources"]
        log("K3", f"{dt} [R={r} S={s}] forward kernel {t['fwd_ms']:.4f} ms "
            f"({t['fwd_repack_ms']:.4f} packing the weights at every launch;"
            f" plain {t['plain_fwd_ms']:.3f}, bound {fb:.4f} by {fby}, every "
            f"operation at the {dt} peak {fone:.4f}; {res['registers']} "
            f"registers x {res['threads']} threads, {res['spill_bytes']} "
            f"bytes spilled per thread, {res['smem_bytes']} B shared memory, "
            f"{res['blocks']} blocks resident); "
            f"backward kernel without weight gradients "
            f"{t['bwd_no_dw_ms']:.4f} ms (bound {bn:.4f} by {bny}; "
            f"{bres['registers']} registers x {bres['threads']} threads, "
            f"{bres['spill_bytes']} bytes spilled per thread, "
            f"{bres['smem_bytes']} B shared memory, {bres['blocks']} blocks "
            f"resident), with them {t['bwd_ms']:.4f} ms (bound {bb:.4f} by "
            f"{bby}; {wres['registers']} registers, {wres['spill_bytes']} "
            f"bytes spilled, {wres['smem_bytes']} B shared memory, "
            f"{wres['blocks']} blocks); plain {t['plain_bwd_ms']:.3f}, every "
            f"operation at the {dt} peak {bone:.4f}; forward+backward to x: "
            f"fused "
            f"Function "
            f"{t['fused_fwd_bwd_ms']:.3f} ms, unfused module with autograd "
            f"{t['module_fwd_bwd_ms']:.3f} ms; {card}")
        del x, gout, gattn0
    return rows, times


def check_delta(name, delta, delta0, src_rgbs, eps):
    """The attack's constraints: inside the eps-ball and the image box, and
    moved from its start."""
    import torch

    worst = float(delta.abs().max())
    lo = float((src_rgbs + delta).min())
    hi = float((src_rgbs + delta).max())
    moved = float((delta - delta0).abs().max())
    if not (worst <= eps + 1e-7 and lo >= -1e-7 and hi <= 1 + 1e-7
            and moved > 0 and bool(torch.isfinite(delta).all())):
        raise AssertionError(f"{name}: max|delta| {worst} (eps {eps}), "
                             f"src + delta in [{lo}, {hi}], moved {moved}")
    return dict(max_abs_delta=worst, eps=eps, min_image=lo, max_image=hi,
                moved=moved)


def run_attack(name, ev, data, card):
    """Warm-up then timed attack iterations on one view through
    ``Evaluator.attack_view_specific``; the launch counters are zeroed
    before the timed run and read after it. Returns (delta, src, stats)."""
    import torch
    from nerfool_tpu_torch.attack.perturb import init_delta
    from nerfool_tpu_torch.ops import ray_attention as ra

    eps = ev.args.epsilon / 255.0
    ev.args.adv_iters = ATTACK_WARMUP
    ev.attack_view_specific(data)
    warm = ev.last_attack
    if not bool(torch.isfinite(warm["losses"]).all()):
        raise AssertionError(f"{name}: non-finite warm-up loss")
    src_rgbs = ev._make_src(data)["rgbs"]
    delta0 = init_delta(ev.generator, src_rgbs, eps)
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    ev.args.adv_iters = ATTACK_ITERS
    delta, src, _ = ev.attack_view_specific(data, delta=delta0)
    run = ev.last_attack
    k5 = expect_k5(name, kernel_counts(), K5_CONVS * ATTACK_ITERS,
                   K5_CONVS * ATTACK_ITERS)
    stats = dict(
        ms_per_iter=run["seconds"] / ATTACK_ITERS * 1e3,
        warmup_ms_per_iter=warm["seconds"] / ATTACK_WARMUP * 1e3,
        losses=[float(x) for x in run["losses"]],
        fwd_launches=ra.ray_attention_fwd.launches,
        bwd_launches=ra.ray_attention_bwd.launches, k5_launches=k5,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        **check_delta(name, delta, delta0, src["rgbs"], eps))
    if not all(map(math.isfinite, stats["losses"])) or len(
            stats["losses"]) != ATTACK_ITERS:
        raise AssertionError(f"{name}: losses {stats['losses']}")
    log(name, f"{ATTACK_ITERS} iterations after {ATTACK_WARMUP} warm-up, "
        f"N_rand {ev.args.N_rand}, {src['rgbs'].shape[0]} source views at "
        f"{tuple(src['rgbs'].shape[1:3])}: {stats['ms_per_iter']:.2f} "
        f"ms/iteration (warm-up {stats['warmup_ms_per_iter']:.2f}); loss "
        f"{stats['losses'][0]:.5f} -> {stats['losses'][-1]:.5f}, all "
        f"finite; max|delta| {stats['max_abs_delta']:.6f} <= {eps:.6f}, "
        f"src + delta in [{stats['min_image']:.4f}, "
        f"{stats['max_image']:.4f}], moved {stats['moved']:.3g}; "
        f"ray_attention launches forward {stats['fwd_launches']}, backward "
        f"{stats['bwd_launches']}; K5 launches forward, input gradient {k5}; "
        f"peak device memory {stats['peak_gib']:.2f} GiB; {card}")
    return delta, src, stats


def frame_psnr(ev, ret, data):
    """The evaluator's own PSNR of a rendered frame (coarse level)."""
    import numpy as np
    import torch
    from nerfool_tpu_torch.metrics.image import img2psnr, psnr

    stride = ev.args.render_stride
    gt = ev._tensor(np.asarray(data["rgb"])[::stride, ::stride])
    fn = img2psnr if ev.args.backbone == "gnt" else psnr
    return float(fn(torch.clamp(ret["outputs_coarse"]["rgb"], 0, 1), gt))


def attacked_render(name, ev, data, src, delta, card):
    """Clean and attacked whole-frame renders of one view; the launch
    counters are zeroed before the attacked render and read after it."""
    import torch
    from nerfool_tpu_torch.ops import bspg_select, ray_attention as ra
    from nerfool_tpu_torch.ops import view_attention as va

    with torch.inference_mode():
        clean = frame_psnr(ev, ev.render_view(data, src), data)
        torch.cuda.synchronize()
        zero_kernel_counts()
        t0 = time.perf_counter()
        ret = ev.render_view(data, src, delta)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    levels = [k for k in ("outputs_coarse", "outputs_fine")
              if ret[k] is not None]
    for level in levels:
        for k in ("rgb", "depth", "weights"):
            if not bool(torch.isfinite(ret[level][k]).all()):
                raise AssertionError(f"{name}: non-finite {level}/{k}")
    hs, ws = ret["outputs_coarse"]["rgb"].shape[:2]
    stats = dict(clean_psnr=clean, attacked_psnr=frame_psnr(ev, ret, data),
                 seconds=seconds, rays_per_s=hs * ws / seconds,
                 k1_launches=bspg_select.select_taps.launches,
                 k3_fwd_launches=ra.ray_attention_fwd.launches,
                 k3_bwd_launches=ra.ray_attention_bwd.launches,
                 k4_launches=va.view_attention.launches,
                 k5_launches=expect_k5(f"{name} attacked render",
                                       kernel_counts(), K5_CONVS, 0))
    if getattr(ev.args, "gnt_fused_attn", "auto") == "on":
        # the same render through the unfused module path (launches read
        # above: this one must add none of the ray attention's)
        ev.args.gnt_fused_attn = "off"
        with torch.inference_mode():
            plain = ev.render_view(data, src, delta)["outputs_coarse"]
        ev.args.gnt_fused_attn = "on"
        if ra.ray_attention_fwd.launches != stats["k3_fwd_launches"]:
            raise AssertionError(f"{name}: the unfused render launched the "
                                 "ray attention kernel")
        errs = {k: float((ret["outputs_coarse"][k] - plain[k]).abs().max())
                for k in ("rgb", "depth", "weights")}
        tols = TOL_FUSED_RENDER
        stats["vs_unfused"] = errs
        log(name, "attacked render, fused ray attention against the unfused "
            "module path: max abs diff " + ", ".join(
                f"{k} {errs[k]:.3g} (tol {tols[k]:g})" for k in errs)
            + f"; {card}")
        if not all(errs[k] <= tols[k] for k in errs):
            raise AssertionError(f"{name}: the fused render disagrees with "
                                 f"the unfused one: {errs}")
        del plain
    log(name, f"attacked render {hs}x{ws} rays in {seconds:.3f} s "
        f"({stats['rays_per_s']:.1f} rays/s), outputs finite; coarse PSNR "
        f"clean {clean:.4f} dB, attacked {stats['attacked_psnr']:.4f} dB; "
        f"launches bspg_select {stats['k1_launches']}, ray_attention forward "
        f"{stats['k3_fwd_launches']}, backward {stats['k3_bwd_launches']}, "
        f"view_attention {stats['k4_launches']}, conv2d forward, input "
        f"gradient {stats['k5_launches']}; {card}")
    return stats


def attn_route_ab(name, ev, data, src, delta, card, exp_k3):
    """The attacked whole-frame render of one view in turns through K3 and
    through the module path's ray attention (``--gnt_fused_attn`` on, off,
    off, on); an ``on`` turn must launch K3's forward ``exp_k3`` times and
    an ``off`` turn none. Returns [(mode, rays/s), ...]."""
    from nerfool_tpu_torch.ops import ray_attention as ra

    turns = []
    for mode in ("on", "off", "off", "on"):
        ev.args.gnt_fused_attn = mode
        before = ra.ray_attention_fwd.launches
        ret, seconds = timed_render(ev, data, src, delta, None)
        launched = ra.ray_attention_fwd.launches - before
        if launched != (exp_k3 if mode == "on" else 0):
            raise AssertionError(f"{name}: --gnt_fused_attn {mode} launched "
                                 f"the ray attention {launched} times")
        hs, ws = ret["rgb"].shape[:2]
        turns.append((mode, hs * ws / seconds))
    ev.args.gnt_fused_attn = "on"
    log(name, "attacked render in turns, rays/s: " + ", ".join(
        f"{'K3' if m == 'on' else 'module'} {x:.1f}" for m, x in turns)
        + f"; {card}")
    return turns


def fused_against_unfused_step(ev, data, delta, card):
    """One attack step from the same ``delta`` and rays through the fused
    route (K3 forward and backward) and through the unfused module path
    with autograd."""
    import dataclasses
    import torch
    from nerfool_tpu_torch.attack.attack import (init_attack_state,
                                                 make_attack_step,
                                                 select_ray_indices)
    from nerfool_tpu_torch.engine import build_attack_config

    target, (h, w) = ev._make_target(data)
    src = ev._make_src(data)
    cfg = build_attack_config(ev.args, h, w)
    sel = select_ray_indices(ev.generator, cfg, ev.device)
    outs = {}
    for fused in (True, False):
        rcfg = dataclasses.replace(ev._grad_render_cfg(),
                                   gnt_fused_attn=fused)
        torch.cuda.reset_peak_memory_stats()
        state0 = init_attack_state(None, cfg, src["rgbs"], delta=delta)
        state, aux = make_attack_step(ev.bundle, rcfg, cfg)(
            state0, target, src, sel=sel)
        torch.cuda.synchronize()
        # Adam's first moment after one step is -0.1 * gradient
        outs[fused] = (float(aux["loss"]), state["delta"] - delta,
                       torch.cuda.max_memory_allocated() / 2 ** 30,
                       state["m"] / -0.1)
        del state, state0, aux
    res = step_limbs(outs[True][0], outs[False][0], outs[True][3],
                     outs[False][3], outs[True][1], outs[False][1])
    log("GNT attack", "one step, fused against unfused from the same delta "
        f"and rays: {res['text']}; peak device memory {outs[True][2]:.2f} "
        f"GiB fused, {outs[False][2]:.2f} GiB unfused; {card}")
    if not res.pop("ok"):
        raise AssertionError("the fused attack step disagrees with the "
                             "unfused one")
    res.pop("text")
    return dict(res, peak_gib_fused=outs[True][2],
                peak_gib_unfused=outs[False][2])


def step_limbs(loss_a, loss_b, g_a, g_b, upd_a, upd_b):
    """Two attack steps from the same delta and rays, route a against route
    b (the reference), held on the limbs set out above STEP_GRAD_FLOOR:
    the loss; the gradient g (read from Adam's first moment) at every entry,
    in relative L2 and by its cosine, and over the entries under the floor;
    delta's update above the floor and the share of all entries within
    TOL_STEP_DELTA_ABS. Returns the readings with 'ok' and a 'text'."""
    import torch

    loss_rel = abs(loss_a - loss_b) / abs(loss_b)
    g_f, g_u = g_a.double(), g_b.double()
    norm = torch.linalg.norm
    grad_rel = float((g_f - g_u).abs().max() / g_u.abs().max())
    grad_l2 = float(norm(g_f - g_u) / norm(g_u))
    cosine = float(torch.sum(g_f * g_u) / (norm(g_f) * norm(g_u)))
    small = g_u.abs() <= STEP_GRAD_FLOOR
    under = float(small.float().mean())
    small_l2 = float(norm((g_f - g_u)[small]) / norm(g_u[small]))
    diff = (upd_a - upd_b).abs()
    upd = float(diff.max())
    upd_floor = float(diff[~small].max()) if (~small).any() else 0.0
    share = float((diff <= TOL_STEP_DELTA_ABS).float().mean())
    text = (
        f"loss {loss_a:.6f} vs {loss_b:.6f} (rel "
        f"{loss_rel:.3g}, tol {TOL_STEP_LOSS_REL:g}); gradient max abs diff "
        f"{grad_rel:.3g} of its largest entry {float(g_u.abs().max()):.3g} "
        f"(tol {TOL_STEP_GRAD_REL:g}), relative L2 {grad_l2:.3g} (tol "
        f"{TOL_STEP_GRAD_L2:g}), cosine {cosine:.10f} (min "
        f"{TOL_STEP_GRAD_COS:g}); over the {under:.6f} of entries with |g| "
        f"<= {STEP_GRAD_FLOOR:g} (max {STEP_FLOOR_SHARE:g}) relative L2 "
        f"{small_l2:.3g} (tol {TOL_STEP_SMALL_GRAD_L2:g}); delta update max "
        f"abs diff {upd_floor:.3g} where |g| > {STEP_GRAD_FLOOR:g} (tol "
        f"{TOL_STEP_DELTA_ABS:g}), {upd:.3g} over all entries, {share:.6f} "
        f"of them within {TOL_STEP_DELTA_ABS:g} (min {TOL_STEP_SHARE:g})")
    ok = (loss_rel <= TOL_STEP_LOSS_REL and grad_rel <= TOL_STEP_GRAD_REL
          and grad_l2 <= TOL_STEP_GRAD_L2 and cosine >= TOL_STEP_GRAD_COS
          and under <= STEP_FLOOR_SHARE
          and small_l2 <= TOL_STEP_SMALL_GRAD_L2
          and upd_floor <= TOL_STEP_DELTA_ABS and share >= TOL_STEP_SHARE)
    return dict(loss_rel=loss_rel, grad_rel_diff=grad_rel,
                grad_rel_l2=grad_l2, grad_cosine=cosine,
                share_under_grad_floor=under, small_grad_rel_l2=small_l2,
                delta_update_diff_above_floor=upd_floor,
                delta_update_diff=upd, delta_update_share_within_tol=share,
                ok=ok, text=text)


def va_operands(v, n, dtype, seed, masked_rows, d=64):
    """K4 operands on the card: qln and k ~ N(0, 1) as after a LayerNorm,
    ray differences with their dot near 1, ~10% of the views masked and the
    first ``masked_rows`` rows masked in every view; weights ~ U(-1/sqrt(in),
    1/sqrt(in)) as a Linear's init, in ``view_attention``'s order."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    u = lambda i, *shape: (torch.rand(*shape, device=dev, generator=g) * 2
                           - 1) / i ** 0.5
    pos = 0.1 * torch.randn(v, n, 4, device=dev, generator=g)
    pos[..., 3] = 1.0 - pos[..., 3].abs()
    mask = (torch.rand(v, n, 1, device=dev, generator=g) > 0.1).float()
    mask[:, :masked_rows] = 0.0
    h = d // 8
    return (torch.randn(n, d, device=dev, generator=g).to(dtype),
            torch.randn(v, n, d, device=dev, generator=g).to(dtype),
            pos.to(dtype), mask.to(dtype),
            u(d, d, d), u(d, d, 2 * d), u(4, 4, h), u(4, h), u(h, h, d),
            u(h, d), u(d, d, h), u(d, h), u(h, h, d), u(h, d), u(d, d, d),
            u(d, d))


def va_bound(v, n, dtype, d=64):
    """K4 at [v, n, d] at the rate each part of its arithmetic runs at:
    qln, k, pos and mask in, out written, the weights once; the kv, qln Wq
    and output products on the tensor cores (f32: three TF32 products at the
    TF32 rate; bf16: one at the bf16 rate), the two MLPs at the f32 rate
    (their times add), or the bytes, whichever is larger."""
    size = 4 if dtype == "f32" else 2
    h = d // 8
    mma = n * (v * 2 * d * 2 * d + 2 * 2 * d * d)
    fma = n * v * (2 * (4 * h + h * d) + 2 * (d * h + h * d))
    w_bytes = 4 * (4 * d * d + 4 * h + 3 * h * d + 2 * h + 3 * d)
    n_bytes = size * (v * n * (d + 4 + 1) + 2 * n * d) + w_bytes
    if dtype == "f32":
        ops_ms = 3 * mma / PEAK_FLOPS["tf32"] * 1e3
    else:
        ops_ms = mma / PEAK_FLOPS["bf16"] * 1e3
    ops_ms += fma / PEAK_FLOPS["f32"] * 1e3
    by_bytes = n_bytes / PEAK_BYTES * 1e3
    return (by_bytes, "bytes") if by_bytes >= ops_ms else (ops_ms,
                                                             "operations")


def va_bound_fma(v, n, dtype, d=64):
    """K4's bound as the FMA kernel's was counted, every operation at the
    rate of the dtype (f32 on the CUDA cores): kept beside the new one."""
    size = 4 if dtype == "f32" else 2
    h = d // 8
    per_view = 2 * d * 2 * d + 2 * (4 * h + h * d) + 2 * (d * h + h * d)
    flops = n * (v * per_view + 2 * 2 * d * d)
    w_bytes = 4 * (4 * d * d + 4 * h + 3 * h * d + 2 * h + 3 * d)
    n_bytes = size * (v * n * (d + 4 + 1) + 2 * n * d) + w_bytes
    return bound_ms(n_bytes, flops, dtype)


def check_view_attention(card, views, samples, render_rays, attack_rays):
    """Phase 13: K4 against its plain version. ``render_rays``: the ray
    counts of the attacked render's chunks (the largest first);
    ``attack_rays``: the attack batch's."""
    import torch
    from nerfool_tpu_torch.ops import view_attention as va

    rows = []
    shapes = [("render chunk", views, r * samples) for r in render_rays]
    shapes += [("attack batch", views, attack_rays * samples),
               ("odd", *VA_ODD_SHAPE)]
    with torch.no_grad():
        for label, v, n in shapes:
            masked = min(VA_MASKED_ROWS, n // 3)
            ops = va_operands(v, n, torch.float32, seed=n, masked_rows=masked)
            before = va.view_attention.launches
            got = va.view_attention(*ops)
            torch.cuda.synchronize()
            if va.view_attention.launches != before + 1:
                raise AssertionError("view_attention did not launch once")
            ref = va.view_attention_plain(*ops)
            err = float((got - ref).abs().max())
            scale = max(1.0, float(ref.abs().max()))
            # rows masked in every view: the uniform 1 / V weights
            p = torch.relu(ops[2][:, :masked] @ ops[6] + ops[7]) @ ops[8] \
                + ops[9]
            vv = (ops[1][:, :masked] @ ops[5])[..., 64:]
            uniform = torch.mean(vv + p, dim=0) @ ops[14] + ops[15]
            masked_err = float((got[:masked] - uniform).abs().max())
            row = dict(shape=label, dtype="f32", views=v, rows=n,
                       masked_rows=masked, max_abs_err=err,
                       tol=TOL_VA_F32_REL * scale, masked_rows_err=masked_err)
            ok = (err <= row["tol"] and masked_err <= row["tol"]
                  and bool(torch.isfinite(got).all()))
            if label != "odd":
                row["ms"] = time_ms(lambda: va.view_attention(*ops), 5)
                row["plain_ms"] = time_ms(
                    lambda: va.view_attention_plain(*ops), 3)
                row["bound_ms"], row["bound_by"] = va_bound(v, n, "f32")
                row["bound_fma_ms"] = va_bound_fma(v, n, "f32")[0]
            rows.append(row)
            log("K4", f"f32 {label} [V={v} N={n}]: max abs err {err:.3g} "
                f"(tol {row['tol']:.3g}), {masked} rows masked in every view "
                f"against the uniform mean {masked_err:.3g}"
                + (f"; kernel {row['ms']:.3f} ms, plain "
                   f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms "
                   f"by {row['bound_by']} (all on the CUDA cores "
                   f"{row['bound_fma_ms']:.3f} ms)" if "ms" in row else "")
                + f"; {card}")
            if not ok:
                raise AssertionError(f"view_attention f32 disagrees with its "
                                     f"plain version: {row}")
            del ops, got, ref, p, vv, uniform

        # bf16 at a whole render chunk and at the attack batch: kernel and
        # plain bf16 against plain f32 on the same bf16 inputs and
        # bf16-valued weights
        for label, v, n in (shapes[0], shapes[-2]):
            ops = va_operands(v, n, torch.bfloat16, seed=n + 1,
                              masked_rows=VA_MASKED_ROWS)
            ref = va.view_attention_plain(*(t.bfloat16().float()
                                            for t in ops))
            got = va.view_attention(*ops)
            plain = va.view_attention_plain(*ops)
            torch.cuda.synchronize()
            err_k = float((got.float() - ref).abs().max())
            err_p = float((plain.float() - ref).abs().max())
            del ref, plain
            row = dict(shape=label, dtype="bf16", views=v, rows=n,
                       max_abs_err=err_k, plain_err=err_p,
                       factor=VA_BF16_FACTOR,
                       ms=time_ms(lambda: va.view_attention(*ops), 5),
                       plain_ms=time_ms(
                           lambda: va.view_attention_plain(*ops), 3))
            row["bound_ms"], row["bound_by"] = va_bound(v, n, "bf16")
            row["bound_fma_ms"] = va_bound_fma(v, n, "bf16")[0]
            rows.append(row)
            log("K4", f"bf16 {label} [V={v} N={n}]: vs f32 plain, kernel err "
                f"{err_k:.3g}, plain bf16 err {err_p:.3g} (bound: kernel <= "
                f"{VA_BF16_FACTOR:g} x plain); kernel {row['ms']:.3f} ms, "
                f"plain {row['plain_ms']:.3f} ms, bound "
                f"{row['bound_ms']:.3f} ms by {row['bound_by']} (all at the "
                f"bf16 rate {row['bound_fma_ms']:.3f} ms); {card}")
            if not (err_k <= VA_BF16_FACTOR * err_p
                    and bool(torch.isfinite(got).all())):
                raise AssertionError(f"view_attention bf16 outside its "
                                     f"bound: {row}")
            del ops, got
    torch.cuda.empty_cache()
    return rows


def kernel_counts():
    """The launch counts of every wrapper, by kernel name."""
    from nerfool_tpu_torch.ops import (bspg_select, chain, conv2d, linear,
                                       ray_attention as ra,
                                       view_attention as va)

    return {"bspg_select": bspg_select.select_taps.launches,
            "gnt_chain": chain.gnt_chain.launches,
            "ray_attention_fwd": ra.ray_attention_fwd.launches,
            "ray_attention_bwd": ra.ray_attention_bwd.launches,
            "ray_attention_bwd_dw": ra.ray_attention_bwd.dw_launches,
            "view_attention": va.view_attention.launches,
            "conv2d_forward": conv2d.conv2d_forward.launches,
            "conv2d_input_grad": conv2d.conv2d_input_grad.launches,
            "dense_forward": linear.dense_forward.launches,
            "dense_input_grad": linear.dense_input_grad.launches}


def zero_kernel_counts():
    from nerfool_tpu_torch.ops import (bspg_select, chain, conv2d, linear,
                                       ray_attention as ra,
                                       view_attention as va)

    for fn in (bspg_select.select_taps, chain.gnt_chain,
               ra.ray_attention_fwd, ra.ray_attention_bwd,
               va.view_attention, conv2d.conv2d_forward,
               conv2d.conv2d_input_grad, linear.dense_forward,
               linear.dense_input_grad):
        fn.launches = 0
    ra.ray_attention_bwd.dw_launches = 0


# K5's launches in one pass of the ResUNet: one per convolution, forward and
# input gradient. A training step asks no input gradient of the stem, whose
# input (the images) needs none: K5_CONVS - 1 there
K5_CONVS = 35


def expect_k5(path, counts, forward, input_grad):
    """K5's [forward, input-gradient] launches in ``counts`` (a
    ``kernel_counts`` dict) on ``path``; raises unless they are ``forward``
    and ``input_grad`` (None: at least one)."""
    got = [counts["conv2d_forward"], counts["conv2d_input_grad"]]
    if not all(g > 0 if w is None else g == w
               for g, w in zip(got, (forward, input_grad))):
        raise AssertionError(f"{path}: K5 launches forward {got[0]}, input "
                             f"gradient {got[1]}; expected {forward} and "
                             f"{input_grad} (None: at least one)")
    return got


def timed_render(ev, data, src, delta, cams):
    """(outputs of the coarse level, seconds) of one whole-frame render."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ret = ev.render_view(data, src, delta, cams)["outputs_coarse"]
    torch.cuda.synchronize()
    return ret, time.perf_counter() - t0


def route_ab(name, ev, card):
    """One test view rendered whole-frame in turns through BSPG (K1) and
    through the per-tap gather (BSPG, per-tap, per-tap, BSPG), rays/s of
    each; a BSPG turn must launch K1 and a per-tap turn must not. Returns
    [(route, rays/s), ...]."""
    from nerfool_tpu_torch.ops import bspg_select

    data = ev.test_dataset[0]
    src = ev._make_src(data)
    turns = []
    for bspg in (True, False, False, True):
        ev.args.use_bspg = bspg
        before = bspg_select.select_taps.launches
        ret, seconds = timed_render(ev, data, src, None, None)
        launched = bspg_select.select_taps.launches - before
        if (launched > 0) != bspg:
            raise AssertionError(f"{name}: --use_bspg {bspg} launched "
                                 f"bspg_select {launched} times")
        hs, ws = ret["rgb"].shape[:2]
        turns.append(("bspg" if bspg else "per_tap", hs * ws / seconds))
    ev.args.use_bspg = True
    log(name, "one view in turns, rays/s: " + ", ".join(
        f"{r} {x:.1f}" for r, x in turns) + f"; {card}")
    return turns


def universal_slice(uev, card, depth, chunks, n_tables):
    """Phase 14 (see the module docstring). Returns the stats dict."""
    import torch
    from nerfool_tpu_torch.attack.perturb import init_delta

    args = uev.args
    eps = args.epsilon / 255.0
    args.adv_iters = ATTACK_WARMUP
    uev.attack_universal()
    warm = uev.last_attack
    if not bool(torch.isfinite(warm["losses"]).all()):
        raise AssertionError("universal: non-finite warm-up loss")

    # evaluate() draws delta's start from the evaluator's generator first
    # thing in the attack: the same draw from a copy of its state
    twin = torch.Generator(device=uev.device)
    twin.set_state(uev.generator.get_state())
    captured = {}
    real_render = uev.render_view

    def spy(data, src, delta=None, src_cameras=None):
        captured.update(data=data, src=src, delta=delta, cams=src_cameras,
                        attack_counts=kernel_counts())
        captured["ret"] = real_render(data, src, delta, src_cameras)
        return captured["ret"]

    uev.render_view = spy
    args.adv_iters = ATTACK_ITERS
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    res = uev.evaluate(max_views=1, verbose=True)["synthetic"]
    total = kernel_counts()
    uev.render_view = real_render
    attack = captured["attack_counts"]
    render = {k: total[k] - attack[k] for k in total}
    run = uev.last_attack
    row = next(v for v in res.values() if isinstance(v, dict))
    src, delta, cams = captured["src"], captured["delta"], captured["cams"]
    delta0 = init_delta(twin, src["rgbs"], eps)
    ret = captured["ret"]["outputs_coarse"]
    for k in ("rgb", "depth", "weights"):
        if not bool(torch.isfinite(ret[k]).all()):
            raise AssertionError(f"universal: non-finite attacked {k}")
    hs, ws = ret["rgb"].shape[:2]
    stats = dict(
        ms_per_iter=run["seconds"] / ATTACK_ITERS * 1e3,
        warmup_ms_per_iter=warm["seconds"] / ATTACK_WARMUP * 1e3,
        losses=[float(x) for x in run["losses"]],
        attack_launches=attack, render_launches=render,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        attacked_psnr=row["coarse_psnr"], render_seconds=row["render_seconds"],
        rays_per_s=hs * ws / row["render_seconds"],
        **check_delta("universal", delta, delta0, src["rgbs"], eps))
    if (len(stats["losses"]) != ATTACK_ITERS
            or not all(map(math.isfinite, stats["losses"]))
            or not math.isfinite(stats["attacked_psnr"])):
        raise AssertionError(f"universal: {stats}")
    log("universal", f"{ATTACK_ITERS} iterations after {ATTACK_WARMUP} "
        f"warm-up over streamed train targets, N_rand {args.N_rand}, "
        f"{src['rgbs'].shape[0]} global source views at "
        f"{tuple(src['rgbs'].shape[1:3])}, pseudo ground truth: "
        f"{stats['ms_per_iter']:.2f} ms/iteration (warm-up "
        f"{stats['warmup_ms_per_iter']:.2f}); loss {stats['losses'][0]:.5f} "
        f"-> {stats['losses'][-1]:.5f}, all finite; max|delta| "
        f"{stats['max_abs_delta']:.6f} <= {eps:.6f}, src + delta in "
        f"[{stats['min_image']:.4f}, {stats['max_image']:.4f}], moved "
        f"{stats['moved']:.3g}; launches in the attack {attack}; peak device "
        f"memory {stats['peak_gib']:.2f} GiB; {card}")
    log("universal", f"attacked render from the global source set {hs}x{ws} "
        f"rays in {row['render_seconds']:.3f} s ({stats['rays_per_s']:.1f} "
        f"rays/s) with the view-attention kernel, outputs finite, coarse "
        f"PSNR {stats['attacked_psnr']:.4f} dB; launches in the render "
        f"{render}; {card}")
    # the attack freezes the weights: no backward with the weight gradients.
    # K5: the clean source views' features once (the pseudo ground truth),
    # then one forward and input gradient an iteration
    want_attack = dict(bspg_select=0, gnt_chain=0, view_attention=0,
                       ray_attention_fwd=2 * ATTACK_ITERS * depth,
                       ray_attention_bwd=ATTACK_ITERS * depth,
                       ray_attention_bwd_dw=0,
                       conv2d_forward=K5_CONVS * (ATTACK_ITERS + 1),
                       conv2d_input_grad=K5_CONVS * ATTACK_ITERS,
                       dense_forward=0, dense_input_grad=0)
    want_render = dict(bspg_select=n_tables * chunks, gnt_chain=0,
                       view_attention=chunks * depth,
                       ray_attention_fwd=chunks * depth, ray_attention_bwd=0,
                       ray_attention_bwd_dw=0, conv2d_forward=K5_CONVS,
                       conv2d_input_grad=0, dense_forward=0,
                       dense_input_grad=0)
    if attack != want_attack or render != want_render:
        raise AssertionError(f"universal launches: attack {attack} (expected "
                             f"{want_attack}), render {render} (expected "
                             f"{want_render})")

    # the same render with the module's view attention: no K4 launch, the
    # same frame; then both routes in turns for their times
    data = captured["data"]
    args.gnt_fused_vt = False
    plain, _ = timed_render(uev, data, src, delta, cams)
    if kernel_counts()["view_attention"] != total["view_attention"]:
        raise AssertionError("the unfused-vt render launched view_attention")
    errs = {k: float((ret[k] - plain[k]).abs().max())
            for k in ("rgb", "depth", "weights")}
    stats["vs_unfused_vt"] = errs
    log("universal", "attacked render, view-attention kernel against the "
        "module's view attention: max abs diff " + ", ".join(
            f"{k} {errs[k]:.3g} (tol {TOL_VT_RENDER[k]:g})" for k in errs)
        + f"; {card}")
    if not all(errs[k] <= TOL_VT_RENDER[k] for k in errs):
        raise AssertionError(f"universal: the K4 render disagrees with the "
                             f"unfused one: {errs}")
    del plain
    turns = []
    for fused in (True, False, False, True):
        args.gnt_fused_vt = fused
        _, seconds = timed_render(uev, data, src, delta, cams)
        turns.append((fused, hs * ws / seconds))
    args.gnt_fused_vt = "auto"
    stats["render_ab_rays_per_s"] = turns
    log("universal", "attacked render in turns, rays/s: " + ", ".join(
        f"{'K4' if f else 'module'} {r:.1f}" for f, r in turns)
        + f"; {card}")
    return stats


def small_universal_modes(ibr_bundle, card):
    """Phase 15: one universal iteration with gradient surgery (IBRNet) and
    one of the camera-pose attack (GNT, small scene), on the card."""
    import tempfile
    import torch
    from nerfool_tpu_torch import eval_adv
    from nerfool_tpu_torch.engine import Evaluator, load_attack_state
    from nerfool_tpu_torch.ops import bspg_select

    out = {}
    args = eval_adv.parse_args(SLICE_ARGV + UNIVERSAL_FLAGS + [
        "--use_pcgrad", "--depth_var_loss", "0.1", "--N_rand", "128",
        "--adv_iters", "1"])
    ev = Evaluator(args, bundle=ibr_bundle, dataset_kwargs=SLICE_DATA,
                   device="cuda", seed=0)
    delta, src, _ = ev.attack_universal()
    loss = float(ev.last_attack["losses"][0])
    out["pcgrad_loss"] = loss
    if not (math.isfinite(loss) and bool(torch.isfinite(delta).all())
            and float(delta.abs().max()) <= args.epsilon / 255.0 + 1e-7):
        raise AssertionError(f"pcgrad iteration: loss {loss}")
    log("small modes", f"--use_pcgrad --depth_var_loss 0.1 (IBRNet, N_rand "
        f"128): loss {loss:.5f}, delta finite and inside the ball; {card}")
    del ev, delta, src

    args = eval_adv.parse_args(GNT_SMALL_ARGV + UNIVERSAL_FLAGS + [
        "--perturb_camera", "--N_rand", "64", "--adv_iters", "1",
        "--i_attack_ckpt", "1", "--gnt_fused_attack", "True",
        "--gnt_fused_attn", "on", "--gnt_fused_vt", "True"])
    ev = Evaluator(args, dataset_kwargs=SMALL_DATA, device="cuda", seed=0)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "attack_state.pt")
        delta, src, cams = ev.attack_universal(ckpt_path=ckpt)
        state, meta = load_attack_state(ckpt)
    loss = float(ev.last_attack["losses"][0])
    rot_eps = args.rot_epsilon / 180.0 * math.pi
    worst_rot = float(state["rot"].abs().max())
    worst_trans = float(state["trans"].abs().max())
    moved = float((cams - src["cameras"]).abs().max())
    before = bspg_select.select_taps.launches
    cfg = ev.view_render_cfg(int(cams.shape[0]))
    ret, _ = timed_render(ev, ev.test_dataset[0], src, delta, cams)
    finite = all(bool(torch.isfinite(ret[k]).all())
                 for k in ("rgb", "depth", "weights"))
    out.update(pose_loss=loss, max_abs_rot=worst_rot,
               max_abs_trans=worst_trans, cameras_moved=moved)
    log("small modes", f"--perturb_camera (GNT, 48x64, N_rand 64): loss "
        f"{loss:.5f}; max|rot| {worst_rot:.5f} <= {rot_eps:.5f} rad, "
        f"max|trans| {worst_trans:.5f} <= {args.trans_epsilon}; source "
        f"cameras moved by up to {moved:.4f}; checkpoint at iteration "
        f"{meta['iters_done']}; attacked render per tap, finite: {finite}; "
        f"{card}")
    if not (math.isfinite(loss) and 0 < worst_rot <= rot_eps + 1e-7
            and 0 < worst_trans <= args.trans_epsilon + 1e-7 and moved > 0
            and meta["iters_done"] == 1 and finite
            and cfg.bspg_specs is None and cfg.gnt_fused_vt
            and bspg_select.select_taps.launches == before):
        raise AssertionError(f"pose-attack iteration: {out}")
    return out


def attack_turns(evs, data):
    """Each evaluator's view-specific attack on ``data``, warmed up, then
    timed in turns (first, second, second, first): {name: [ms/iteration of
    each turn]}, and each evaluator's ``last_attack`` of its last turn."""
    turns = {}
    for name, ev in evs.items():
        ev.args.adv_iters = DEF_WARMUP
        ev.attack_view_specific(data)
    names = list(evs)
    for name in (names[0], names[1], names[1], names[0]):
        ev = evs[name]
        ev.args.adv_iters = DEF_ITERS
        ev.attack_view_specific(data)
        turns.setdefault(name, []).append(
            ev.last_attack["seconds"] / DEF_ITERS * 1e3)
    return turns


def check_pose(name, ev, delta, src):
    """The attack's constraints on ``delta``, ``rot`` and ``trans``."""
    import torch

    state = ev.last_attack["state"]
    eps = ev.args.epsilon / 255.0
    rot_eps = ev.args.rot_epsilon / 180.0 * math.pi
    worst = float(delta.abs().max())
    lo = float((src["rgbs"] + delta).min())
    hi = float((src["rgbs"] + delta).max())
    rot = float(state["rot"].abs().max())
    trans = float(state["trans"].abs().max())
    ok = (worst <= eps + 1e-7 and lo >= -1e-7 and hi <= 1 + 1e-7
          and 0 < rot <= rot_eps + 1e-7
          and 0 < trans <= ev.args.trans_epsilon + 1e-7
          and bool(torch.isfinite(delta).all()))
    if not ok:
        raise AssertionError(f"{name}: max|delta| {worst} (eps {eps}), src "
                             f"+ delta in [{lo}, {hi}], max|rot| {rot}, "
                             f"max|trans| {trans}")
    return dict(max_abs_delta=worst, max_abs_rot=rot, max_abs_trans=trans)


def zbuffer_repeats(ev, data, card):
    """A source view's depth z-buffered into the target over the whole
    frame twice on the card: bit for bit equal (the scatter is a min)."""
    import torch
    from nerfool_tpu_torch.attack.warp import forward_warp

    src = ev._make_src(data)
    target, (h, w) = ev._make_target(data)
    sel = torch.randperm(h * w, device="cuda",
                         generator=torch.Generator("cuda").manual_seed(0))
    k = lambda cam: cam[2:18].reshape(4, 4)[:3, :3]
    e = lambda cam: cam[18:34].reshape(4, 4)
    s_cam, t_cam = src["cameras"][0], target["camera"]
    run = lambda: forward_warp(sel[:512], src["rgbs"][0], src["depths"][0],
                               k(s_cam), e(s_cam), k(t_cam), e(t_cam),
                               src2tar=True, derive_full_image=True)
    a, b = run(), run()
    same = all(torch.equal(x, y) for x, y in zip(a, b))
    hits = int((a[1] > 0).sum())
    log("defended attack", f"z-buffered warp of a {h}x{w} source depth, twice "
        f"on the card: bit for bit equal {same}, {hits} pixels hit; {card}")
    if not (same and hits > 0):
        raise AssertionError("the z-buffer differs between two runs")
    return dict(zbuffer_bit_identical=same, zbuffer_hits=hits)


def defended_attack(ibr_bundle, gnt_bundle, card):
    """Phase 16 (see the module docstring). Returns the stats dict."""
    import torch
    from nerfool_tpu_torch import eval_adv
    from nerfool_tpu_torch.engine import Evaluator

    t_phase = time.perf_counter()
    out = {}
    make = lambda argv, bundle: Evaluator(
        eval_adv.parse_args(argv), bundle=bundle, dataset_kwargs=SLICE_DATA,
        device="cuda", seed=0)
    # (a) the consistency terms on IBRNet, in turns with the plain attack
    plain = make(IBR_ATTACK_ARGV + ["--use_bspg", "False"], ibr_bundle)
    cons = make(IBR_ATTACK_ARGV + CONS_FLAGS + ["--use_bspg", "False"],
                ibr_bundle)
    data = cons.test_dataset[0]
    turns = attack_turns({"plain": plain, "consistency": cons}, data)
    if set(cons.last_attack["terms"]) != {"rgb", "depth_cons",
                                          "camera_cons"}:
        raise AssertionError(f"terms {cons.last_attack['terms']}")
    delta, src, _ = cons.attack_view_specific(data)
    out["consistency"] = check_pose("consistency attack", cons, delta, src)
    ds = make(IBR_ATTACK_ARGV + CONS_FLAGS + ["--ds_rgb", "--use_bspg",
                                              "False"], ibr_bundle)
    ds_turns = attack_turns({"plain": plain, "ds_rgb": ds}, data)
    delta, src, _ = ds.attack_view_specific(data)
    out["ds_rgb"] = check_pose("ds_rgb attack", ds, delta, src)
    losses = [float(x) for e in (cons, ds) for x in e.last_attack["losses"]]
    if not all(map(math.isfinite, losses)):
        raise AssertionError(f"consistency losses {losses}")
    out["ms_per_iter"] = {**turns, "ds_rgb": ds_turns["ds_rgb"],
                          "plain_with_ds_rgb": ds_turns["plain"]}
    log("defended attack", f"IBRNet, N_rand {cons.args.N_rand}, "
        f"{src['rgbs'].shape[0]} source views, ms/iteration in turns: plain "
        + ", ".join(f"{x:.2f}" for x in turns["plain"]) + "; consistency "
        + ", ".join(f"{x:.2f}" for x in turns["consistency"]) + "; plain "
        + ", ".join(f"{x:.2f}" for x in ds_turns["plain"]) + "; with "
        "--ds_rgb " + ", ".join(f"{x:.2f}" for x in ds_turns["ds_rgb"])
        + f"; terms {cons.last_attack['terms']}; delta, rot and trans inside "
        f"their bounds {out['consistency']}, {out['ds_rgb']}; {card}")
    out.update(zbuffer_repeats(cons, data, card))
    del plain, cons, ds

    # (b) purification and the noise defense on GNT, then hybrid frames
    dev = make(GNT_ATTACK_ARGV + DEFENSE_FLAGS, gnt_bundle)
    depth = dev.args.trans_depth
    data = dev.test_dataset[0]
    dev.args.adv_iters, dev.args.purif_iters = DEF_WARMUP, 1
    dev.attack_view_specific(data)
    zero_kernel_counts()
    dev.args.adv_iters, dev.args.purif_iters = DEF_ITERS, PURIF_ITERS
    delta, src, cams = dev.attack_view_specific(data)
    counts = kernel_counts()
    exp = (DEF_ITERS + PURIF_ITERS) * depth
    purif_ms = dev.last_purify["seconds"] / PURIF_ITERS * 1e3
    purif_losses = [float(x) for x in dev.last_purify["losses"]]
    out["purification"] = dict(
        ms_per_step=purif_ms, attack_ms_per_iter=dev.last_attack["seconds"]
        / DEF_ITERS * 1e3, losses=purif_losses, launches=counts,
        defenses=list(dev.last_defenses))
    log("defended attack", f"GNT f32, N_rand {dev.args.N_rand}: "
        f"{DEF_ITERS} attack iterations "
        f"({out['purification']['attack_ms_per_iter']:.2f} ms each), "
        f"{PURIF_ITERS} purification steps ({purif_ms:.2f} ms each, loss "
        f"{purif_losses[0]:.5f} -> {purif_losses[-1]:.5f}), then "
        f"{dev.last_defenses}; ray_attention launches forward "
        f"{counts['ray_attention_fwd']}, backward "
        f"{counts['ray_attention_bwd']} (expected {exp} each: "
        f"{depth} per iteration and per purification step); {card}")
    expect_k5("defended GNT attack", counts,
              K5_CONVS * (DEF_ITERS + PURIF_ITERS),
              K5_CONVS * (DEF_ITERS + PURIF_ITERS))
    if (counts["ray_attention_fwd"], counts["ray_attention_bwd"]) != (
            exp, exp) or dev.last_defenses != ["purification",
                                               "random_noise"] or not (
            all(map(math.isfinite, purif_losses))
            and bool(torch.isfinite(delta).all())):
        raise AssertionError(f"defended GNT attack: {out['purification']}")
    hs = len(range(0, SLICE_DATA["h"], dev.args.render_stride))
    ws = len(range(0, SLICE_DATA["w"], dev.args.render_stride))
    chunks = -(-hs * ws // dev.args.chunk_size)
    del dev
    for mode in ("use_clean_density", "use_clean_color"):
        hev = make(GNT_ATTACK_ARGV + ["--use_bspg", "False", f"--{mode}"],
                   gnt_bundle)
        zero_kernel_counts()
        ret, seconds = timed_render(hev, data, src, delta, cams)
        counts = kernel_counts()
        expect_k5(f"hybrid frame --{mode}", counts, None, 0)
        finite = all(bool(torch.isfinite(ret[k]).all())
                     for k in ("rgb", "depth", "weights"))
        exp = chunks * depth * 2  # the coarse level's two branches
        out[mode] = dict(rays_per_s=hs * ws / seconds, seconds=seconds,
                         launches=counts, finite=finite)
        log("defended attack", f"hybrid frame --{mode}, {hs}x{ws} rays in "
            f"{seconds:.3f} s ({hs * ws / seconds:.1f} rays/s), outputs "
            f"finite {finite}; launches ray_attention forward "
            f"{counts['ray_attention_fwd']}, view_attention "
            f"{counts['view_attention']} (expected {exp} each), "
            f"bspg_select {counts['bspg_select']}; {card}")
        if not (finite and counts["ray_attention_fwd"] == exp
                and counts["view_attention"] == exp
                and counts["ray_attention_bwd"] == 0
                and counts["bspg_select"] == 0):
            raise AssertionError(f"hybrid frame --{mode}: {out[mode]}")
        del hev, ret
    out["seconds"] = time.perf_counter() - t_phase
    log("defended attack", f"phase took {out['seconds']:.1f} s; {card}")
    return out


def filtered_png(path, img):
    """Write uint8 [H, W, 3] ``img`` as a PNG whose rows take the five row
    filters in turn (None, Sub, Up, Average, Paeth), as an encoder with
    adaptive filtering mixes them."""
    import zlib

    import numpy as np

    h, w, c = img.shape
    cur = img.reshape(h, w * c).astype(np.int32)
    up = np.concatenate([np.zeros((1, w * c), np.int32), cur[:-1]])
    left = np.concatenate([np.zeros((h, c), np.int32), cur[:, :-c]], 1)
    ul = np.concatenate([np.zeros((h, c), np.int32), up[:, :-c]], 1)
    pa, pb, pc = abs(up - ul), abs(left - ul), abs(left + up - 2 * ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    kind = np.arange(h)[:, None] % 5
    pred = np.choose(kind, [np.zeros_like(cur), left, up, (left + up) // 2,
                            paeth])
    raw = np.concatenate([kind, (cur - pred) & 255], 1).astype(np.uint8)

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + chunk(b"IEND", b""))


def png_header(path):
    """(width, height, bit depth, colour type) from a PNG's IHDR."""
    with open(path, "rb") as f:
        head = f.read(26)
    if head[:8] != b"\x89PNG\r\n\x1a\n" or head[12:16] != b"IHDR":
        raise AssertionError(f"{path} is not a PNG")
    return struct.unpack(">IIBB", head[16:26])


def lpips_rows(name, ev, wpath, tmp, card):
    """One clean view through ``Evaluator.evaluate`` with LPIPS and the
    dumps; LPIPS against a recompute on the card and the CPU's of the same
    frame; the dumps' file set and headers. Returns the stats dict."""
    import numpy as np
    import torch
    from nerfool_tpu_torch.metrics import lpips as lp

    out_dir = os.path.join(tmp, name)
    res = ev.evaluate(max_views=1, verbose=False, out_dir=out_dir)
    data = ev.test_dataset[0]
    fid = os.path.splitext(os.path.basename(data["rgb_path"]))[0]
    row = res["synthetic"][fid]
    src = ev._make_src(data)
    with torch.inference_mode():
        ret = ev.render_view(data, src)
    stride = ev.args.render_stride
    gt_np = np.asarray(data["rgb"])[::stride, ::stride]
    gt = ev._tensor(gt_np)
    card_fn = ev._build_lpips()
    cpu_fn = lp.LPIPS(card_fn.normalize).load_params(
        lp.load_lpips_weights(wpath))
    levels = [lv for lv in ("coarse", "fine")
              if ret[f"outputs_{lv}"] is not None]
    stats = {"levels": {}}
    for lv in levels:
        pred = torch.clamp(ret[f"outputs_{lv}"]["rgb"], 0, 1)
        with torch.no_grad():
            again = float(card_fn(pred[None], gt[None])[0])
            ms = time_ms(lambda: card_fn(pred[None], gt[None]), 5)
            cpu = float(cpu_fn(pred[None].cpu(), gt[None].cpu())[0])
        rel = abs(again - cpu) / abs(cpu)
        stats["levels"][lv] = dict(lpips=row[f"{lv}_lpips"], recompute=again,
                                   cpu=cpu, rel_err=rel, ms=ms)
        if not (math.isfinite(row[f"{lv}_lpips"])
                and abs(row[f"{lv}_lpips"] - again) <= 1e-6 * abs(again)
                and rel <= TOL_LPIPS_REL):
            raise AssertionError(f"{name} {lv} LPIPS: {stats['levels'][lv]}")
    if ev.args.backbone == "gnt" and (levels != ["coarse"] or math.isfinite(
            row["fine_lpips"])):
        raise AssertionError(f"GNT LPIPS levels {levels}, row {row}")
    # the dumps: the exact file set, each header against its array
    hs, ws = gt_np.shape[:2]
    h, w = np.asarray(data["rgb"]).shape[:2]
    want = {f"{fid}_gt_rgb.png": (ws, hs, 8, 2),
            f"{fid}_average.png": (w, h, 8, 2)}
    for lv in levels:
        outs = ret[f"outputs_{lv}"]
        want[f"{fid}_pred_{lv}.png"] = want[f"{fid}_err_map_{lv}.png"] = (
            ws, hs, 8, 2)
        if outs.get("depth") is not None:
            want[f"{fid}_depth_{lv}.png"] = (ws, hs, 16, 0)
            want[f"{fid}_depth_vis_{lv}.png"] = (ws, hs, 8, 2)
        if outs.get("weights") is not None:
            want[f"{fid}_acc_map_{lv}.png"] = (ws, hs, 8, 2)
    for j in range(src["rgbs"].shape[0]):
        want[f"adv_src_0_{j}.png"] = (w, h, 8, 2)
    got = {f for f in os.listdir(out_dir) if f.endswith(".png")}
    if got != set(want):
        raise AssertionError(f"{name} dumps: {sorted(got ^ set(want))} "
                             "differ from the expected set")
    for f, head in want.items():
        if png_header(os.path.join(out_dir, f)) != head:
            raise AssertionError(f"{name} {f}: IHDR "
                                 f"{png_header(os.path.join(out_dir, f))}, "
                                 f"expected {head}")
    stats["files"] = len(want)
    log("evaluator outputs", f"{name} {hs}x{ws}: LPIPS " + ", ".join(
        f"{lv} {v['lpips']:.6f} (card again {v['recompute']:.6f}, CPU "
        f"{v['cpu']:.6f}, rel {v['rel_err']:.2g} <= {TOL_LPIPS_REL:g}; "
        f"{v['ms']:.2f} ms per frame)" for lv, v in stats["levels"].items())
        + f"; {len(want)} PNGs, headers match their arrays, plus "
        f"{sorted(set(os.listdir(out_dir)) - got)}; {card}")
    return stats


def feature_dtype_turns(name, evs, data, card):
    """The view-specific attack with f32 and bf16 features in turns (f32,
    bf16, bf16, f32) after a warm-up each: ms/iteration, the K3 launches
    of each evaluator's timed turns, the constraints on the bf16 delta."""
    import torch

    for ev in evs.values():
        ev.args.adv_iters = DEF_WARMUP
        ev.attack_view_specific(data)
    turns, launches = {}, {}
    for key in ("f32", "bf16", "bf16", "f32"):
        ev = evs[key]
        ev.args.adv_iters = DEF_ITERS
        zero_kernel_counts()
        ev.attack_view_specific(data)
        counts = kernel_counts()
        turns.setdefault(key, []).append(
            ev.last_attack["seconds"] / DEF_ITERS * 1e3)
        for k in ("ray_attention_fwd", "ray_attention_bwd",
                  "conv2d_forward", "conv2d_input_grad"):
            launches.setdefault(key, {}).setdefault(k, 0)
            launches[key][k] += counts[k]
        if not bool(torch.isfinite(ev.last_attack["losses"]).all()):
            raise AssertionError(f"{name} {key}: non-finite losses")
    # bf16 features keep the library's convolutions
    for key, want in (("f32", 2 * DEF_ITERS * K5_CONVS), ("bf16", 0)):
        expect_k5(f"{name} attack, {key} features", launches[key], want,
                  want)
    bf = evs["bf16"]
    delta = bf.last_attack["state"]["delta"]
    src = bf._make_src(data)
    bounds = check_delta(f"{name} bf16 features", delta,
                         torch.zeros_like(delta), src["rgbs"],
                         bf.args.epsilon / 255.0)
    log("evaluator outputs", f"{name} attack, ms/iteration in turns: f32 "
        "features " + ", ".join(f"{x:.2f}" for x in turns["f32"])
        + "; bf16 features " + ", ".join(f"{x:.2f}" for x in turns["bf16"])
        + f"; K3 and K5 launches {launches}; bf16 delta inside its bounds "
        f"{bounds}"
        f"; {card}")
    return dict(ms_per_iter=turns, launches=launches, delta=bounds)


def evaluator_outputs(ibr_plan, gnt_plan, ibr_bundle, gnt_bundle, card):
    """Phase 17 (see the module docstring). Returns the stats dict."""
    import numpy as np
    import torch
    from nerfool_tpu_torch import eval as port_eval, eval_adv
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.metrics import lpips as lp
    from nerfool_tpu_torch.ops import bspg_select

    t_phase = time.perf_counter()
    out = {}

    def make(parse, argv, bundle=None, plan=None):
        ev = Evaluator(parse(argv), bundle=bundle, dataset_kwargs=SLICE_DATA,
                       device="cuda", seed=0)
        if plan is not None:
            ev.adopt_plan(plan)
        return ev

    with tempfile.TemporaryDirectory() as tmp:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            weights = lp.LPIPS().params()
        wpath = os.path.join(tmp, "lpips_random.npz")
        lp.save_lpips_weights(weights, wpath)
        extra = ["--lpips_weights", wpath, "--export_adv_source_img"]
        out["ibrnet_rows"] = lpips_rows(
            "IBRNet", make(port_eval.parse_args, SLICE_ARGV + extra,
                           ibr_bundle, ibr_plan), wpath, tmp, card)
        out["gnt_rows"] = lpips_rows(
            "GNT", make(port_eval.parse_args, GNT_ARGV + extra, gnt_bundle,
                        gnt_plan), wpath, tmp, card)

    # K1 at the IBRNet slice's shapes with bf16 tables, both levels
    args = ibr_plan.args
    spec_f, spec_r = ibr_plan.view_render_cfg(args.num_source_views).bspg_specs
    levels = (("coarse", args.N_samples),
              ("fine", args.N_samples + args.N_importance))
    shapes = []
    for table, spec, c in (("feat", spec_f, 32), ("rgb", spec_r, 3)):
        shapes += select_shapes(spec, c, table, levels, (torch.bfloat16,),
                                args.num_source_views, args.chunk_size)
    out["k1_bf16"] = check_select(shapes, "ibrnet_bf16", 200, card)

    # the attacks with bf16 features, in turns with f32 features
    flags = ["--use_bspg", "False"]
    bf = ["--feature_dtype", "bfloat16"]
    ibr = {"f32": make(eval_adv.parse_args, IBR_ATTACK_ARGV + flags,
                       ibr_bundle),
           "bf16": make(eval_adv.parse_args, IBR_ATTACK_ARGV + flags + bf)}
    data = ibr["f32"].test_dataset[0]
    out["ibrnet_attack"] = feature_dtype_turns("IBRNet", ibr, data, card)
    del ibr
    gnt = {"f32": make(eval_adv.parse_args, GNT_ATTACK_ARGV + flags,
                       gnt_bundle),
           "bf16": make(eval_adv.parse_args, GNT_ATTACK_ARGV + flags + bf)}
    depth = gnt["f32"].args.trans_depth
    out["gnt_attack"] = feature_dtype_turns("GNT", gnt, data, card)
    for key, counts in out["gnt_attack"]["launches"].items():
        exp = 2 * DEF_ITERS * depth  # two timed turns each
        if (counts["ray_attention_fwd"], counts["ray_attention_bwd"]) != (
                exp, exp):
            raise AssertionError(f"GNT attack, {key} features: K3 launches "
                                 f"{counts}, expected {exp} each")
    del gnt

    # the IBRNet frame in bf16, in turns with f32, on BSPG and per tap
    evs = {dt: make(port_eval.parse_args, SLICE_ARGV + [
        "--compute_dtype", dt], ibr_bundle, ibr_plan)
           for dt in ("float32", "bfloat16")}
    src = evs["float32"]._make_src(data)
    hh, ww = SLICE_DATA["h"], SLICE_DATA["w"]
    bh, bw = spec_f.block
    n_chunks = -(-(-(-hh // bh) * bh * -(-ww // bw) * bw) // args.chunk_size)
    exp_k1 = (len(spec_f.groups) + len(spec_r.groups)) * len(levels) \
        * n_chunks
    rates, rgb, k1_bf16 = {}, {}, 0
    for bspg in (True, False):
        for dt in ("float32", "bfloat16", "bfloat16", "float32"):
            ev = evs[dt]
            ev.args.use_bspg = bspg
            before = bspg_select.select_taps.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.inference_mode():
                ret = ev.render_view(data, src)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launched = bspg_select.select_taps.launches - before
            if launched != (exp_k1 if bspg else 0):
                raise AssertionError(f"IBRNet {dt} frame, BSPG {bspg}: K1 "
                                     f"launched {launched}, expected "
                                     f"{exp_k1 if bspg else 0}")
            if dt == "bfloat16" and bspg:
                k1_bf16 += launched
            for lv in ("outputs_coarse", "outputs_fine"):
                for k in ("rgb", "depth", "weights"):
                    if not bool(torch.isfinite(ret[lv][k]).all()):
                        raise AssertionError(f"IBRNet {dt}: non-finite "
                                             f"{lv}/{k}")
            route = "bspg" if bspg else "per_tap"
            rates.setdefault(f"{route}_{dt}", []).append(hh * ww / seconds)
            rgb[(route, dt)] = ret["outputs_coarse"]["rgb"].float()
            del ret
    err = {r: float((rgb[(r, "bfloat16")] - rgb[(r, "float32")]).abs().max())
           for r in ("bspg", "per_tap")}
    del rgb, evs
    out["ibrnet_bf16_frame"] = dict(rays_per_s=rates, rgb_err=err,
                                    k1_launches=k1_bf16)
    log("evaluator outputs", f"IBRNet frame {hh}x{ww}, rays/s in turns: "
        + "; ".join(f"{k} " + ", ".join(f"{x:.1f}" for x in v)
                    for k, v in rates.items())
        + f"; coarse rgb bf16 vs f32 max abs: BSPG {err['bspg']:.4g}, per "
        f"tap {err['per_tap']:.4g} (BSPG <= {IBR_BF16_FACTOR:g} x per tap); "
        f"K1 launches in the bf16 BSPG frames {k1_bf16}; {card}")
    if not 0 < err["bspg"] <= IBR_BF16_FACTOR * err["per_tap"]:
        raise AssertionError(f"IBRNet bf16 frame errors {err}")
    out["seconds"] = time.perf_counter() - t_phase
    log("evaluator outputs", f"phase took {out['seconds']:.1f} s; {card}")
    return out


def run_training(name, argv, card):
    """``python -m nerfool_tpu_torch.train``'s ``main`` on ``argv``:
    (trainer, stats) with the ms per step over the last ``TRAIN_STEPS``
    steps (host clock; each step ends in a synchronize, its loss read), the
    losses, peak device memory and the kernels it launched."""
    import numpy as np
    import torch
    from nerfool_tpu_torch.train.__main__ import main as train_main

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_kernel_counts()
    t0 = time.perf_counter()
    trainer = train_main(argv)
    seconds = time.perf_counter() - t0
    counts = kernel_counts()
    hist = trainer.history
    n = TRAIN_WARMUP + TRAIN_STEPS
    if [h["step"] for h in hist] != list(range(1, n + 1)):
        raise AssertionError(f"{name}: logged steps "
                             f"{[h['step'] for h in hist]}")
    losses = [h["loss"] for h in hist]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{name}: losses {losses}")
    stats = dict(
        ms_per_step=(hist[-1]["time"] - hist[TRAIN_WARMUP - 1]["time"])
        / TRAIN_STEPS * 1e3, losses=losses, seconds=seconds,
        peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        n_rand=trainer.cfg.n_rand, launches=counts)
    log(name, f"{TRAIN_STEPS} steps after {TRAIN_WARMUP} warm-up through "
        f"the entry point, N_rand {trainer.cfg.n_rand}, "
        f"{trainer.last_batch['src_rgbs'].shape[0]} source views at "
        f"{tuple(trainer.last_batch['src_rgbs'].shape[1:3])}: "
        f"{stats['ms_per_step']:.2f} ms/step; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}, all finite; peak device memory "
        f"{stats['peak_gib']:.2f} GiB; kernel launches {counts}; main "
        f"{seconds:.1f} s; {card}")
    return trainer, stats


def params_moved(trainer, start):
    """Each parameter group's largest move from ``start`` (the bundle the
    run began from), with every parameter finite; raises where a group did
    not move."""
    import torch

    named = {id(p): (m, n) for m, mod in trainer._modules().items()
             for n, p in mod.named_parameters()}
    init = {m: dict(mod.named_parameters())
            for m, mod in (("feature_net", start.feature_net),
                           ("net_coarse", start.net_coarse),
                           ("net_fine", start.net_fine)) if mod is not None}
    moved, still = [], {}
    for group in trainer.optimizer.param_groups:
        most = 0.0
        for p in group["params"]:
            m, n = named[id(p)]
            if not bool(torch.isfinite(p).all()):
                raise AssertionError(f"non-finite {m}.{n}")
            d = float((p.detach().cpu() - init[m][n].detach()).abs().max())
            if d == 0:  # a gradient of exactly zero at every step
                still[m] = still.get(m, 0) + 1
            most = max(most, d)
        moved.append(most)
    if not all(m > 0 for m in moved):
        raise AssertionError(f"a parameter group did not move: {moved}")
    return dict(group_max_move=moved, tensors_unmoved=still)


def train_step_limbs(outs, names):
    """The limbs of ``fused_against_unfused_step`` applied to every
    parameter tensor's gradient from one step of each route with the same
    draws, and to Adam's first update ``lr g / (|g| + 1e-8)``. Per tensor:
    the largest entry's difference, the relative L2, the cosine and the
    update where |g| > STEP_GRAD_FLOOR; over the whole step's gradient,
    where single entries near Adam's eps would decide a small tensor: the
    relative L2 of the entries under the floor and the share of entries
    whose update agrees. Delta's limb on the share under the floor (at most
    half) is not applied: the random-weight ResUNet's weight gradients put
    most parameter entries under it (0.87, measured on an H100), and
    the per-tensor limbs above keep the comparison from being vacuous. A
    tensor whose gradient is zero in exact arithmetic (a convolution's bias
    ahead of an InstanceNorm, which removes it; the bias of the view
    attention's last layer ahead of the softmax over views, which no shift
    changes) carries f32 rounding noise alone, ~1e-11 of the step's largest
    entry: it is held to staying below TRAIN_GRAD_NOISE of that entry on
    both routes."""
    import torch

    (loss_f, g_fs, lrs), (loss_u, g_us, _) = outs[True], outs[False]
    norm = torch.linalg.norm
    top = max(float(g.abs().max()) for g in g_us)
    rows, small_d, small_g, agree = [], [], [], []
    for name, g_f, g_u, lr in zip(names, g_fs, g_us, lrs):
        g_f, g_u = g_f.double().reshape(-1), g_u.double().reshape(-1)
        big = max(float(g_u.abs().max()), float(g_f.abs().max()))
        row = dict(name=name, numel=g_u.numel(), grad_max=big)
        if big <= TRAIN_GRAD_NOISE * top:
            row.update(noise=True, ok=True)
            rows.append(row)
            continue
        small = g_u.abs() <= STEP_GRAD_FLOOR
        small_d.append((g_f - g_u)[small])
        small_g.append(g_u[small])
        upd = lambda g: lr * g / (g.abs() + 1e-8)
        diff = (upd(g_f) - upd(g_u)).abs()
        agree.append(diff <= TOL_STEP_DELTA_ABS)
        scale = float(g_u.abs().max())
        row.update(
            grad_rel=float((g_f - g_u).abs().max()) / scale,
            grad_l2=float(norm(g_f - g_u) / norm(g_u)),
            cosine=float(torch.sum(g_f * g_u) / (norm(g_f) * norm(g_u))),
            under=float(small.double().mean()),
            upd_floor=(float(diff[~small].max()) if bool((~small).any())
                       else 0.0),
            share=float((diff <= TOL_STEP_DELTA_ABS).double().mean()))
        row["ok"] = (row["grad_rel"] <= TOL_STEP_GRAD_REL
                     and row["grad_l2"] <= TOL_STEP_GRAD_L2
                     and row["cosine"] >= TOL_STEP_GRAD_COS
                     and row["upd_floor"] <= TOL_STEP_DELTA_ABS)
        rows.append(row)
    small_d, small_g = torch.cat(small_d), torch.cat(small_g)
    return dict(loss_rel=abs(loss_f - loss_u) / abs(loss_u), tensors=rows,
                grad_max=top, under=small_g.numel() / sum(
                    r["numel"] for r in rows if not r.get("noise")),
                small_l2=float(norm(small_d) / norm(small_g)),
                share=float(torch.cat(agree).double().mean()))


def gnt_train_step_check(trainer, card):
    """One GNT training step's gradients through K3 (forward, and backward
    with the weight gradients) against the same step, with the same draws,
    through the module path on the card (``train_step_limbs``)."""
    import dataclasses
    import torch
    from nerfool_tpu_torch.train.trainer import make_train_step

    batch = trainer.last_batch
    draws = trainer.step_fn.draw(
        torch.Generator(device="cuda").manual_seed(1), batch)
    named = [(f"{m}.{n}", p) for m, mod in trainer._modules().items()
             for n, p in mod.named_parameters()]
    outs, launches = {}, {}
    for fused in (True, False):
        step, opt, _ = make_train_step(
            trainer.bundle, dataclasses.replace(trainer.render_cfg,
                                                gnt_fused_attn=fused),
            trainer.cfg)
        lr = {id(p): g["lr"] for g in opt.param_groups for p in g["params"]}
        zero_kernel_counts()
        aux, grads = step.loss_and_grads(batch, draws)
        torch.cuda.synchronize()
        launches[fused] = kernel_counts()
        expect_k5(f"GNT training step, fused {fused}", launches[fused],
                  K5_CONVS, K5_CONVS - 1)
        by_id = dict(zip(map(id, step.params), grads))
        outs[fused] = (float(aux["loss"]), [by_id[id(p)] for _, p in named],
                       [lr[id(p)] for _, p in named])
    res = train_step_limbs(outs, [n for n, _ in named])
    res["launches"] = {"fused": launches[True], "module": launches[False]}
    rows = [r for r in res["tensors"] if not r.get("noise")]
    noise = [r["name"] for r in res["tensors"] if r.get("noise")]
    bad = [r["name"] for r in rows if not r["ok"]]
    worst = {k: max(r[k] for r in rows) for k in ("grad_rel", "grad_l2",
                                                  "upd_floor")}
    worst.update(cosine=min(r["cosine"] for r in rows),
                 share=min(r["share"] for r in rows))  # reported only
    res["worst"] = worst
    log("GNT training", f"one step, K3 against the module path with the same "
        f"draws, {len(rows)} parameter tensors: loss rel "
        f"{res['loss_rel']:.3g} (tol {TOL_STEP_LOSS_REL:g}); worst tensor's "
        f"gradient max abs diff {worst['grad_rel']:.3g} of its largest entry "
        f"(tol {TOL_STEP_GRAD_REL:g}), relative L2 {worst['grad_l2']:.3g} "
        f"(tol {TOL_STEP_GRAD_L2:g}), cosine {worst['cosine']:.10f} (min "
        f"{TOL_STEP_GRAD_COS:g}); Adam's first update max abs diff "
        f"{worst['upd_floor']:.3g} where |g| > {STEP_GRAD_FLOOR:g} (tol "
        f"{TOL_STEP_DELTA_ABS:g}), over all entries {res['share']:.6f} "
        f"within it (min {TOL_STEP_SHARE:g}; the least tensor's "
        f"{worst['share']:.6f}); the {res['under']:.4f}"
        f" of entries with |g| <= {STEP_GRAD_FLOOR:g}: relative L2 "
        f"{res['small_l2']:.3g} (tol {TOL_STEP_SMALL_GRAD_L2:g}); "
        f"{len(noise)} tensors zero in exact arithmetic below "
        f"{TRAIN_GRAD_NOISE:g} of the largest entry "
        f"{res['grad_max']:.3g} on both routes; launches fused "
        f"{launches[True]}, module {launches[False]}; failing {bad}; {card}")
    if (bad or res["loss_rel"] > TOL_STEP_LOSS_REL
            or res["small_l2"] > TOL_STEP_SMALL_GRAD_L2
            or res["share"] < TOL_STEP_SHARE):
        raise AssertionError("the GNT training step through K3 disagrees "
                             "with the module path")
    return res


def profile_training(name, trainer, stream, card):
    """Two more steps of ``trainer`` under ``torch.profiler``: device time
    per step by kernel and operator (``profile_attack.profile_device``),
    the ResUNet's convolutions and K3 (its forward, backward and weight
    packing kernels) within it."""
    import torch
    from nerfool_tpu_torch import profile_attack

    steps = 2
    gen = torch.Generator(device="cuda").manual_seed(3)
    _, tables = profile_attack.profile_device(
        lambda: trainer.train(stream, steps, generator=gen, i_print=1,
                              log_fn=lambda s: None), name, steps)
    per = lambda rows, keep: sum(r[0] for r in rows if keep(r[2])) / steps
    out = dict(device_ms=per(tables["kernel"], lambda k: True),
               conv_fwd_ms=per(tables["operator"],
                               lambda k: k == "aten::cudnn_convolution"),
               conv_bwd_ms=per(tables["operator"],
                               lambda k: k == "aten::convolution_backward"),
               k3_ms=per(tables["kernel"], lambda k: any(
                   f"ra_{part}_kernel" in k for part in ("fwd", "bwd",
                                                         "pack"))),
               wall_ms=(trainer.history[-1]["time"]
                        - trainer.history[-steps]["time"]) / (steps - 1)
               * 1e3)
    conv = out["conv_fwd_ms"] + out["conv_bwd_ms"]
    log(name, f"profiled: {out['device_ms']:.1f} ms of device kernel time a "
        f"step, of it the ResUNet's convolutions {out['conv_fwd_ms']:.1f} "
        f"forward + {out['conv_bwd_ms']:.1f} backward "
        f"({100 * conv / out['device_ms']:.1f}%), K3 {out['k3_ms']:.2f}; "
        f"{card}")
    return out


def training(card):
    """Phase 18 (see the module docstring). Returns the stats dict."""
    import dataclasses
    import torch
    from nerfool_tpu_torch.data import create_training_dataset
    from nerfool_tpu_torch.data.base import Loader
    from nerfool_tpu_torch.models.bundle import create_model
    from nerfool_tpu_torch.train.__main__ import parse_args
    from nerfool_tpu_torch.train.trainer import Trainer

    t_phase = time.perf_counter()
    out = {}
    n = TRAIN_WARMUP + TRAIN_STEPS
    with tempfile.TemporaryDirectory() as tmp:
        # (a) IBRNet, with one i_img panel set at the last step
        argv = IBR_TRAIN_ARGV + ["--out_dir", tmp, "--expname", "ibrnet",
                                 "--i_img", str(n)]
        args = parse_args(argv)
        start = create_model(args=args, seed=args.seed)
        trainer, stats = run_training("IBRNet training", argv, card)
        if any(v for k, v in stats["launches"].items()
               if not k.startswith("conv2d")):
            raise AssertionError("IBRNet training launched a kernel other "
                                 "than K5")
        # a forward a step, and one more for the panels' render
        stats["k5_launches"] = expect_k5("IBRNet training",
                                         stats["launches"],
                                         K5_CONVS * (n + 1),
                                         (K5_CONVS - 1) * n)
        stats.update(params_moved(trainer, start))
        path = os.path.join(tmp, "ibrnet", f"model_{n:06d}.pth")
        loaded = create_model(args=args, ckpt_path=path, device="cuda")
        for name, mod in trainer._modules().items():
            want = mod.state_dict()
            got = getattr(loaded, name).state_dict()
            if set(got) != set(want) or not all(
                    torch.equal(got[k], want[k]) for k in want):
                raise AssertionError(f"{name} reloaded from {path} differs")
        img_dir = os.path.join(tmp, "ibrnet", "images")
        panels = sorted(os.listdir(img_dir))
        want_panels = [f"val_{k}_{n:08d}.png" for k in (
            "depth_coarse", "depth_fine", "gt_rgb", "pred_coarse",
            "pred_fine")]
        heads = {f: png_header(os.path.join(img_dir, f)) for f in panels}
        if panels != want_panels or any(
                hd[:2] != (SLICE_DATA["w"], SLICE_DATA["h"])
                for hd in heads.values()):
            raise AssertionError(f"log_view panels {heads}")
        stats.update(checkpoint=os.path.basename(path), panels=panels)
        stream = iter(Loader(create_training_dataset(
            args, **args.dataset_kwargs), shuffle=True, seed=777,
            num_workers=2, infinite=True))
        stats["profile"] = profile_training("IBRNet training", trainer,
                                            stream, card)
        stream.close()
        log("IBRNet training", f"every parameter group moved (largest move "
            f"{stats['group_max_move']}, unmoved tensors by module "
            f"{stats['tensors_unmoved']}), all finite; "
            f"{os.path.basename(path)} reloaded through create_model with "
            f"equal tensors; log_view panels "
            f"{panels} at {SLICE_DATA['w']}x{SLICE_DATA['h']}; {card}")
        out["ibrnet"] = stats
        del trainer, loaded, start

        # (b) IBRNet with adversarial training
        argv = IBR_TRAIN_ARGV + ["--out_dir", tmp, "--expname", "adv",
                                 "--i_img", "0", "--use_adv_train",
                                 "--adv_iters", "3"]
        trainer, stats = run_training("IBRNet adversarial training", argv,
                                      card)
        if any(v for k, v in stats["launches"].items()
               if not k.startswith("conv2d")):
            raise AssertionError("IBRNet training launched a kernel other "
                                 "than K5")
        # each step: the inner attack's iterations, then the step itself
        inner = trainer.cfg.adv_iters
        stats["k5_launches"] = expect_k5(
            "IBRNet adversarial training", stats["launches"],
            K5_CONVS * (inner + 1) * n, (K5_CONVS * inner + K5_CONVS - 1) * n)
        eps = trainer.cfg.epsilon / 255.0
        delta = trainer.last_aux["delta"]
        src = trainer.last_batch["src_rgbs"]
        stats.update(adv_iters=trainer.cfg.adv_iters,
                     max_abs_delta=float(delta.abs().max()), eps=eps,
                     min_image=float((src + delta).min()),
                     max_image=float((src + delta).max()))
        log("IBRNet adversarial training", f"--adv_iters "
            f"{trainer.cfg.adv_iters}: the last step's inner delta max abs "
            f"{stats['max_abs_delta']:.6f} <= {eps:.6f}, src + delta in "
            f"[{stats['min_image']:.4f}, {stats['max_image']:.4f}]; {card}")
        if not (stats["max_abs_delta"] <= eps + 1e-7
                and stats["min_image"] >= -1e-7
                and stats["max_image"] <= 1 + 1e-7
                and stats["max_abs_delta"] > 0
                and bool(torch.isfinite(delta).all())):
            raise AssertionError("the inner delta left its bounds")
        out["ibrnet_adv"] = stats
        del trainer

        # (c) GNT through K3, forward and backward with the weight gradients
        argv = GNT_TRAIN_ARGV + ["--out_dir", tmp, "--expname", "gnt"]
        args = parse_args(argv)
        trainer, stats = run_training("GNT training", argv, card)
        levels = 2 if args.N_importance > 0 else 1
        exp = n * args.trans_depth * levels
        got = stats["launches"]
        if (got["ray_attention_fwd"], got["ray_attention_bwd"],
                got["ray_attention_bwd_dw"], got["view_attention"],
                got["gnt_chain"], got["bspg_select"]) != (exp, exp, exp, 0,
                                                          0, 0):
            raise AssertionError(f"GNT training launches {got}, expected K3 "
                                 f"forward, backward and backward with the "
                                 f"weight gradients {exp} each, no other")
        stats["k5_launches"] = expect_k5("GNT training", got, K5_CONVS * n,
                                         (K5_CONVS - 1) * n)
        stats["step_check"] = gnt_train_step_check(trainer, card)
        # the two routes in turns, on the same stream of train views
        stream = iter(Loader(create_training_dataset(
            args, **args.dataset_kwargs), shuffle=True, seed=777,
            num_workers=2, infinite=True))
        gen = torch.Generator(device="cuda").manual_seed(2)
        turns = []
        for fused in (True, False, False, True):
            tr = Trainer(trainer.bundle, dataclasses.replace(
                trainer.render_cfg, gnt_fused_attn=fused), trainer.cfg,
                out_dir=os.path.join(tmp, "turns"))
            zero_kernel_counts()
            tr.train(stream, TRAIN_TURN_STEPS, generator=gen, i_print=1,
                     log_fn=lambda s: None)
            k3 = kernel_counts()["ray_attention_bwd_dw"]
            if k3 != (TRAIN_TURN_STEPS * args.trans_depth * levels
                      if fused else 0):
                raise AssertionError(f"route {fused}: {k3} K3 launches")
            h = tr.history
            turns.append(("K3" if fused else "module",
                          (h[-1]["time"] - h[0]["time"])
                          / (TRAIN_TURN_STEPS - 1) * 1e3))
        stats["profile"] = profile_training("GNT training", tr, stream,
                                            card)
        if not stats["profile"]["k3_ms"] > 0:
            raise AssertionError("the profiled GNT steps show no K3 kernel")
        stream.close()
        stats["turns_ms_per_step"] = turns
        log("GNT training", "steps in turns, ms/step: " + ", ".join(
            f"{r} {ms:.2f}" for r, ms in turns) + f"; {card}")
        out["gnt"] = stats
        del trainer
    out["seconds"] = time.perf_counter() - t_phase
    log("training", f"phase took {out['seconds']:.1f} s; {card}")
    return out


class ShareBatches:
    """A model bundle whose feature net runs on each rank's share of the
    source views apart (``RaySplit.rows``), the maps concatenated: the
    split step's feature-net batches in one process. Everything else is
    the wrapped bundle's."""

    def __init__(self, bundle, world):
        self.bundle, self.world = bundle, world

    def __getattr__(self, name):
        return getattr(self.bundle, name)

    def extract_features(self, x):
        import torch
        from nerfool_tpu_torch.parallel.mesh import RaySplit

        parts = [self.bundle.extract_features(
            x[RaySplit(r, self.world).rows(x.shape[0])])
            for r in range(self.world)]
        coarse = torch.cat([p[0] for p in parts])
        if parts[0][1] is parts[0][0]:
            return coarse, coarse
        return coarse, torch.cat([p[1] for p in parts])


def feature_batches(bundle, x, world, seed=11):
    """The feature net's batch effect on the card: its maps and its
    input gradient (the VJP of a seeded normal cotangent) in f32 on all
    views at once (one process) and on each rank's share apart (the
    split), each against the same in float64. Returns, for 'maps' and
    'vjp', each route's largest deviation from float64 as a share of
    float64's largest entry and in relative L2, and the routes' from each
    other."""
    import copy
    import torch

    def route(b, xx, cots):
        xx = xx.detach().requires_grad_(True)
        with torch.enable_grad():
            coarse, fine = b.extract_features(xx)
            maps = (coarse,) if fine is coarse else (coarse, fine)
            g, = torch.autograd.grad(maps, xx, cots[:len(maps)])
        return torch.cat([m.reshape(-1) for m in maps]).double(), \
            g.reshape(-1).double()

    with torch.no_grad():
        shapes = [m.shape for m in bundle.extract_features(x[:1])]
    gen = torch.Generator(device=x.device).manual_seed(seed)
    cots = [torch.randn((x.shape[0],) + tuple(sh[1:]), device=x.device,
                        generator=gen) for sh in shapes]
    net64 = copy.deepcopy(bundle.feature_net).double()
    b64 = copy.copy(bundle)
    b64.feature_net = net64
    ref = route(b64, x.double(), [c.double() for c in cots])
    del net64, b64
    whole = route(bundle, x, cots)
    shares = route(ShareBatches(bundle, world), x, cots)
    norm = torch.linalg.norm
    out = {}
    for i, what in enumerate(("maps", "vjp")):
        r = ref[i]
        dev = lambda a, b: (float((a - b).abs().max() / b.abs().max()),
                            float(norm(a - b) / norm(b)))
        out[what] = {"whole_vs_f64": dev(whole[i], r),
                     "shares_vs_f64": dev(shares[i], r),
                     "shares_vs_whole": dev(shares[i], whole[i])}
    return out


def split_rank(rank, world, init, tmp):
    """Phase 19 (a), one rank of ``world`` on the card, run as ``python3
    chip_smoke.py --split-rank RANK WORLD INIT_URL DIR``: the GNT attack
    evaluator at the attack slice's widths finds the group and splits its
    source views and rays. Every rank draws the same delta and rays; it
    runs the split attack step, the split attacked frame (the plan of phase
    9, from DIR), the gathers of the feature maps alone, the split IBRNet
    attack step and the split train step (its own view and draws, the
    gradients averaged); rank 0 alone then runs each one-process
    counterpart while the other ranks wait. Results go to DIR/rankN.pt."""
    sys.path.insert(0, ROOT)
    import dataclasses
    import pickle
    import torch
    import torch.distributed as dist
    from nerfool_tpu_torch import eval_adv
    from nerfool_tpu_torch.attack.attack import (init_attack_state,
                                                 make_attack_step,
                                                 select_ray_indices)
    from nerfool_tpu_torch.attack.perturb import init_delta
    from nerfool_tpu_torch.config import port_parser
    from nerfool_tpu_torch.data import create_training_dataset
    from nerfool_tpu_torch.engine import (Evaluator, build_attack_config,
                                          render_config_from_args)
    from nerfool_tpu_torch.parallel import distributed as pd
    from nerfool_tpu_torch.parallel.mesh import ray_split
    from nerfool_tpu_torch.train.trainer import (make_batch, make_train_step,
                                                 train_config_from_args)
    from nerfool_tpu_torch.utils.profiling import device_memory_stats

    pd.initialize(backend="gloo", device="cuda", init_method=init,
                  world_size=world, rank=rank)
    split = ray_split()
    out = {"rank": rank}

    def attack_setup(argv):
        """The attack evaluator of ``argv`` (it must find the group), its
        test view, and the delta and rays that every rank draws alike."""
        e = Evaluator(eval_adv.parse_args(argv), dataset_kwargs=SLICE_DATA,
                      device="cuda", seed=0)
        if e.split != split or split is None:
            raise AssertionError(f"rank {rank}: the evaluator's split "
                                 f"{e.split}, the group's {split}")
        d = e.test_dataset[0]
        tgt, (hh, ww) = e._make_target(d)
        s = e._make_src(d)
        c = build_attack_config(e.args, hh, ww)
        g = torch.Generator(device="cuda").manual_seed(7)
        d0 = init_delta(g, s["rgbs"], c.eps)
        rays = [select_ray_indices(g, c, "cuda")
                for _ in range(SPLIT_ITERS + 1)]
        return e, d, tgt, s, c, d0, rays

    def attack(e, tgt, s, c, d0, rays, sp, bundle=None):
        """Warm-up step (the one compared), then SPLIT_ITERS timed; the
        views the feature net took in each call, and this process's
        allocated bytes before the steps and at their peak. ``bundle``:
        the evaluator's by default."""
        bundle = e.bundle if bundle is None else bundle
        step = make_attack_step(bundle, e._grad_render_cfg(), c, split=sp)
        state = init_attack_state(None, c, s["rgbs"], delta=d0)
        views = []
        hook = bundle.feature_net.register_forward_pre_hook(
            lambda _, inputs: views.append(int(inputs[0].shape[0])))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = device_memory_stats()[f"cuda:{torch.cuda.current_device()}"]
        for i, sel in enumerate(rays):
            if i == 1:
                torch.cuda.synchronize()
                zero_kernel_counts()
                t0 = time.perf_counter()
            state, aux = step(state, tgt, s, sel=sel)
            if i == 0:  # Adam's first moment after one step is -0.1 g
                first = dict(loss=float(aux["loss"]),
                             update=(state["delta"] - d0).cpu(),
                             g=(state["m"] / -0.1).cpu())
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / SPLIT_ITERS * 1e3
        mem = device_memory_stats()[f"cuda:{torch.cuda.current_device()}"]
        hook.remove()
        return dict(first, ms_per_iter=ms, launches=kernel_counts(),
                    views=views, base_bytes=base["bytes_in_use"],
                    peak_bytes=mem["peak_bytes_in_use"],
                    delta=state["delta"])

    def gathers(e, s, reps=5):
        """The feature maps' gather alone, forward and backward (host
        clock, each ending in a synchronize), at the maps this rank's
        views give: ms of each, and the bytes of the whole maps."""
        with torch.no_grad():
            local = e.bundle.extract_features(
                s["rgbs"][split.rows(s["rgbs"].shape[0])])
        coarse = local[0].detach().requires_grad_(True)
        fine = (coarse if local[1] is local[0]
                else local[1].detach().requires_grad_(True))
        leaves = [coarse] if fine is coarse else [coarse, fine]
        fwd, bwd = [], []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = split.view_features(lambda _: (coarse, fine), s["rgbs"])
            full = full[:len(leaves)]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            torch.autograd.grad(full, leaves,
                                [torch.ones_like(m) for m in full])
            torch.cuda.synchronize()
            fwd.append((t1 - t0) * 1e3)
            bwd.append((time.perf_counter() - t1) * 1e3)
        return dict(fwd_ms=fwd[1:], bwd_ms=bwd[1:],
                    bytes=sum(m.numel() * m.element_size() for m in full))

    ev, data, target, src, cfg, delta0, sels = attack_setup(GNT_ATTACK_ARGV)
    with open(os.path.join(tmp, "plan.pkl"), "rb") as f:
        ev._bspg_specs, ev._bspg_hw = pickle.load(f)
    h, w = cfg.h, cfg.w

    def render(delta):
        """One attacked whole-frame render (untimed warm-up: the attack)."""
        with torch.inference_mode():
            torch.cuda.synchronize()
            zero_kernel_counts()
            t0 = time.perf_counter()
            ret = ev.render_view(data, src, delta)["outputs_coarse"]
            torch.cuda.synchronize()
        return dict(seconds=time.perf_counter() - t0,
                    launches=kernel_counts(),
                    frame={k: ret[k].float().cpu()
                           for k in ("rgb", "depth", "weights")})

    gnt_attack = (ev, target, src, cfg, delta0, sels)
    out["attack"] = attack(*gnt_attack, split)
    delta = out["attack"].pop("delta")
    out["render"] = render(delta)
    dist.barrier()
    if rank == 0:
        one = attack(*gnt_attack, None)
        one.pop("delta")
        out["attack_one"] = one
        out["attack_one_shares"] = attack(*gnt_attack, None,
                                          ShareBatches(ev.bundle, world))
        out["attack_one_shares"].pop("delta")
        out["features"] = {"gnt": feature_batches(
            ev.bundle, src["rgbs"] + delta0, world)}
        ev.split = None
        out["render_one"] = render(delta)
        ev.split = split
    dist.barrier()
    del delta
    out["gathers"] = {"gnt": gathers(ev, src)}

    # the IBRNet attack step: the feature net is most of its iteration
    iev, _, itarget, isrc, icfg, idelta0, isels = attack_setup(
        IBR_ATTACK_ARGV)
    ibr_attack = (iev, itarget, isrc, icfg, idelta0, isels)
    out["ibr_attack"] = attack(*ibr_attack, split)
    out["ibr_attack"].pop("delta")
    dist.barrier()
    if rank == 0:
        one = attack(*ibr_attack, None)
        one.pop("delta")
        out["ibr_attack_one"] = one
        out["ibr_attack_one_shares"] = attack(*ibr_attack, None,
                                              ShareBatches(iev.bundle, world))
        out["ibr_attack_one_shares"].pop("delta")
        out["features"]["ibrnet"] = feature_batches(
            iev.bundle, isrc["rgbs"] + idelta0, world)
    dist.barrier()
    out["gathers"]["ibrnet"] = gathers(iev, isrc)
    del iev, ibr_attack, isrc

    # the train step: GNT at gnt_full.txt's widths through K3 with dW
    targs = port_parser().parse_args(GNT_TRAIN_ARGV)
    ds = create_training_dataset(targs, **targs.dataset_kwargs)
    batches = [make_batch(ds[r], "cuda") for r in range(world)]
    tcfg = train_config_from_args(targs, h, w,
                                  batches[0]["src_rgbs"].shape[0])
    trcfg = dataclasses.replace(render_config_from_args(targs),
                                gnt_fused_attn=True)
    bundle = ev.bundle
    names = {id(p): f"{m}.{n}" for m, mod in (
        ("feature_net", bundle.feature_net), ("net_coarse", bundle.net_coarse),
        ("net_fine", bundle.net_fine)) if mod is not None
        for n, p in mod.named_parameters()}
    ref_step, ref_opt, _ = make_train_step(bundle, trcfg, tcfg)
    gens = [torch.Generator(device="cuda").manual_seed(pd.host_seed(0, r))
            for r in range(world)]
    draws = [ref_step.draw(gens[r], batches[r]) for r in range(world)]
    lrs = {id(p): g["lr"] for g in ref_opt.param_groups for p in g["params"]}
    out["train_names"] = [names[id(p)] for p in ref_step.params]
    out["train_lrs"] = [lrs[id(p)] for p in ref_step.params]
    if rank == 0:  # the ranks' mean gradient, before any update
        grads, losses = None, []
        for r in range(world):
            aux, g = ref_step.loss_and_grads(batches[r], draws[r])
            losses.append(float(aux["loss"]))
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
        out["train_one"] = dict(losses=losses,
                                grads=[(g / world).cpu() for g in grads])
        del grads
    dist.barrier()
    step, opt, _ = make_train_step(bundle, trcfg, tcfg, split=split)
    zero_kernel_counts()
    aux = step(batches[rank], draws=draws[rank])
    torch.cuda.synchronize()
    launches = kernel_counts()
    out["train"] = dict(
        loss=float(aux["loss"]), launches=launches,
        grads=[(opt.state[p]["exp_avg"] / (1 - 0.9)).cpu()
               for p in step.params])

    def steps(fn):
        fn(batches[rank], generator=gens[rank])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(SPLIT_ITERS):
            fn(batches[rank], generator=gens[rank])
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / SPLIT_ITERS * 1e3

    out["train"]["ms_per_step"] = steps(step)
    dist.barrier()
    if rank == 0:
        out["train_one"]["ms_per_step"] = steps(ref_step)
    dist.barrier()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
    dist.destroy_process_group()


def split_paths(plan, depth, n_rays, chunk, card):
    """Phase 19 (a): two ranks on the one card (``split_rank``), each held
    against the one-process run on rank 0: the GNT and IBRNet attack steps
    (``step_limbs`` against one process in the ranks' feature-net batches,
    ``feature_batches`` against float64; the feature net's views per rank,
    each its ``host_shard``; peak memory; the two-rank factor), the gathers
    of the feature maps timed alone, the attacked frame (TOL_FUSED_RENDER:
    the same chunks through the same kernels), the train step's gradients
    (``train_step_limbs``); K1's, K3's and K4's launches per rank.
    ``plan``: (specs, frame) of phase 9; ``n_rays``: the frame's rays
    padded to whole blocks."""
    import pickle
    import torch
    from nerfool_tpu_torch.parallel.mesh import RaySplit

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "plan.pkl"), "wb") as f:
            pickle.dump(plan, f)
        env = {k: v for k, v in os.environ.items() if k not in (
            "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")}
        init = f"file://{tmp}/rendezvous"
        procs, logs = [], []
        for r in range(SPLIT_WORLD):
            logs.append(open(os.path.join(tmp, f"rank{r}.log"), "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--split-rank",
                 str(r), str(SPLIT_WORLD), init, tmp], stdout=logs[-1],
                stderr=subprocess.STDOUT, env=env, cwd=ROOT))
        fails = []
        for r, (p, lg) in enumerate(zip(procs, logs)):
            try:
                rc = p.wait(timeout=SPLIT_TIMEOUT)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                p.wait()
                rc = "timeout"
            lg.seek(0)
            tail = lg.read()[-4000:]
            lg.close()
            if rc != 0:
                fails.append(f"rank {r} rc={rc}:\n{tail}")
        for p in procs:  # none outlives the phase
            if p.poll() is None:
                p.kill()
                p.wait()
        if fails:
            raise AssertionError("split ranks failed:\n" + "\n".join(fails))
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                            weights_only=False) for r in range(SPLIT_WORLD)]
    r0, r1 = ranks
    out = {}
    # (1) the attack steps, GNT (through K3) and IBRNet: the split against
    # one process in the ranks' feature-net batches (what the split alone
    # changes), the feature net's batch effect against float64, and the
    # split against the one-process step as a user runs it
    exp = SPLIT_ITERS * depth
    mb = lambda b: b / 2 ** 20
    for name, key in (("GNT", "attack"), ("IBRNet", "ibr_attack")):
        a, one, alike = r0[key], r0[key + "_one"], r0[key + "_one_shares"]
        res = step_limbs(a["loss"], alike["loss"], a["g"], alike["g"],
                         a["update"], alike["update"])
        ok = res.pop("ok")
        whole = step_limbs(a["loss"], one["loss"], a["g"], one["g"],
                           a["update"], one["update"])
        whole.pop("ok")
        feat = r0["features"][name.lower()]
        feat_ok = all(f["shares_vs_f64"][i] <= TOL_FEATURE_BATCH * max(
            f["whole_vs_f64"][i], TOL_FEATURE_BATCH_FLOOR)
            for f in feat.values() for i in (0, 1))
        same = all(torch.equal(r0[key][k], r1[key][k])
                   for k in ("update", "g")) and r0[key]["loss"] == \
            r1[key]["loss"]
        views = [r[key]["views"] for r in ranks]
        n_views = one["views"][0]
        shares = []
        for r in ranks:  # host_shard's whole views, one call a step
            rows = RaySplit(r["rank"], SPLIT_WORLD).rows(n_views)
            shares.append(rows.stop - rows.start)
        ms = [r[key]["ms_per_iter"] for r in ranks]
        factor = max(ms) / one["ms_per_iter"]
        peak = [mb(r[key]["peak_bytes"] - r[key]["base_bytes"])
                for r in ranks]
        one_peak = mb(one["peak_bytes"] - one["base_bytes"])
        launches = [r[key]["launches"] for r in ranks]
        fmt = lambda d: ", ".join(f"{k} {v[0]:.3g} (L2 {v[1]:.3g})"
                                  for k, v in d.items())
        log("split", f"{name} attack step on {SPLIT_WORLD} ranks against one "
            f"process with the feature net in the ranks' view batches, from "
            f"the same delta and rays: {res.pop('text')}; the ranks hold "
            f"the same step bit for bit: {same}; feature-net views per step "
            f"on the ranks {[v[0] for v in views]} (one process {n_views}); "
            f"ms/iteration {ms} on the ranks, {one['ms_per_iter']:.2f} in "
            f"one process: the two-rank factor {factor:.3f}; peak MiB above "
            f"the steps' start {peak} on the ranks, {one_peak:.1f} in one "
            f"process; launches per rank {launches}; {card}")
        log("split", f"{name} feature net's batch effect (f32, largest "
            f"deviation as a share of float64's largest entry): maps "
            f"{fmt(feat['maps'])}; input gradient {fmt(feat['vjp'])}; the "
            f"shares may sit at most {TOL_FEATURE_BATCH:g}x the whole "
            f"batch's distance from float64: {feat_ok}. The split against "
            f"the one-process step on all views at once: "
            f"{whole.pop('text')}; {card}")
        if not ok or not same or not feat_ok:
            raise AssertionError(f"the split {name} attack step disagrees "
                                 "with the one-process step")
        if (views != [[n] * (SPLIT_ITERS + 1) for n in shares]
                or one["views"] != [n_views] * (SPLIT_ITERS + 1)
                or alike["views"] != shares * (SPLIT_ITERS + 1)):
            raise AssertionError(f"the {name} feature net took views "
                                 f"{views} on the ranks, {one['views']} and "
                                 f"{alike['views']} in one process; the "
                                 f"shares are {shares}")
        for x in (launches + [one["launches"]] if name == "GNT" else []):
            if (x["ray_attention_fwd"], x["ray_attention_bwd"]) != (exp, exp):
                raise AssertionError(f"split attack launches {x}, expected "
                                     f"{exp} forward and backward")
        # every rank holds views: one pass of the feature net a step each
        for x in launches + [one["launches"]]:
            expect_k5(f"split {name} attack", x, K5_CONVS * SPLIT_ITERS,
                      K5_CONVS * SPLIT_ITERS)
        out[key] = dict(res, ms_per_iter=ms,
                        one_ms_per_iter=one["ms_per_iter"],
                        two_rank_factor=factor, views=shares,
                        one_views=n_views, peak_mib=peak,
                        one_peak_mib=one_peak, launches=launches,
                        one_launches=one["launches"], features=feat,
                        against_whole_batch=whole)
    for name, g in r0["gathers"].items():
        both = [r["gathers"][name] for r in ranks]
        log("split", f"{name} feature maps' gather ({mb(g['bytes']):.1f} MiB "
            f"on every rank) forward ms {[x['fwd_ms'] for x in both]}, "
            f"backward (the reduce-scatter) ms {[x['bwd_ms'] for x in both]} "
            f"on the ranks; {card}")
    out["gathers"] = {name: [r["gathers"][name] for r in ranks]
                      for name in r0["gathers"]}
    # (2) the attacked frame
    one = r0["render_one"]
    errs = {k: max(float((r["render"]["frame"][k] - one["frame"][k]).abs()
                         .max()) for r in ranks) for k in TOL_FUSED_RENDER}
    same = all(torch.equal(r0["render"]["frame"][k], r1["render"]["frame"][k])
               for k in TOL_FUSED_RENDER)
    groups = sum(len(sp.groups) for sp in plan[0][next(iter(plan[0]))])
    for r in ranks:
        rows = RaySplit(r["rank"], SPLIT_WORLD).rows(n_rays, chunk)
        k = -(-(rows.stop - rows.start) // chunk) * depth
        got = r["render"]["launches"]
        if (got["ray_attention_fwd"], got["view_attention"]) != (k, k) or \
                got["bspg_select"] != groups * k // depth:
            raise AssertionError(f"rank {r['rank']} attacked-frame launches "
                                 f"{got}, expected K3 and K4 {k}, K1 "
                                 f"{groups * k // depth}")
        expect_k5(f"rank {r['rank']} attacked frame", got, K5_CONVS, 0)
    log("split", f"attacked GNT frame on {SPLIT_WORLD} ranks against one "
        "process: max abs diff " + ", ".join(
            f"{k} {errs[k]:.3g} (tol {TOL_FUSED_RENDER[k]:g})" for k in errs)
        + f"; the ranks' frames equal: {same}; seconds "
        f"{[r['render']['seconds'] for r in ranks]} on the ranks, "
        f"{one['seconds']:.3f} in one process; launches per rank "
        f"{[r['render']['launches'] for r in ranks]}; {card}")
    if not same or not all(errs[k] <= TOL_FUSED_RENDER[k] for k in errs):
        raise AssertionError("the split attacked frame disagrees with the "
                             "one-process frame")
    out["render"] = dict(errors=errs, seconds=[r["render"]["seconds"]
                                               for r in ranks],
                         one_seconds=one["seconds"],
                         launches=[r["render"]["launches"] for r in ranks],
                         one_launches=one["launches"])
    # (3) the train step
    one = r0["train_one"]
    lrs, names = r0["train_lrs"], r0["train_names"]
    res = train_step_limbs({True: (r0["train"]["loss"], r0["train"]["grads"],
                                   lrs),
                            False: (one["losses"][0], one["grads"], lrs)},
                           names)
    rows = [x for x in res["tensors"] if not x.get("noise")]
    bad = [x["name"] for x in rows if not x["ok"]]
    same = all(torch.equal(x, y) for x, y in zip(r0["train"]["grads"],
                                                  r1["train"]["grads"]))
    worst = {k: max(x[k] for x in rows) for k in ("grad_rel", "grad_l2",
                                                  "upd_floor")}
    worst["cosine"] = min(x["cosine"] for x in rows)
    exp = depth
    launches = [r["train"]["launches"] for r in ranks]
    log("split", f"GNT train step on {SPLIT_WORLD} ranks (each its own view "
        f"and draws) against one process with the ranks' gradients "
        f"averaged, {len(rows)} parameter tensors: rank 0's loss rel "
        f"{res['loss_rel']:.3g}; worst tensor's gradient max abs diff "
        f"{worst['grad_rel']:.3g} of its largest entry, relative L2 "
        f"{worst['grad_l2']:.3g}, cosine {worst['cosine']:.10f}; Adam's "
        f"first update max abs diff {worst['upd_floor']:.3g} where |g| > "
        f"{STEP_GRAD_FLOOR:g}, {res['share']:.6f} of entries within "
        f"{TOL_STEP_DELTA_ABS:g}; entries under the floor relative L2 "
        f"{res['small_l2']:.3g}; the ranks' mean gradients equal: {same}; "
        f"ms/step {[r['train']['ms_per_step'] for r in ranks]} on the ranks, "
        f"{one['ms_per_step']:.2f} in one process; launches per rank "
        f"{launches}; failing {bad}; {card}")
    if (bad or not same or res["loss_rel"] > TOL_STEP_LOSS_REL
            or res["small_l2"] > TOL_STEP_SMALL_GRAD_L2
            or res["share"] < TOL_STEP_SHARE):
        raise AssertionError("the split train step disagrees with the "
                             "one-process step")
    for x in launches:
        if (x["ray_attention_fwd"], x["ray_attention_bwd"],
                x["ray_attention_bwd_dw"]) != (exp, exp, exp):
            raise AssertionError(f"split train launches {x}, expected {exp}")
        expect_k5("split train step", x, K5_CONVS, K5_CONVS - 1)
    out["train"] = dict(loss_rel=res["loss_rel"], worst=worst,
                        share=res["share"], small_l2=res["small_l2"],
                        ms_per_step=[r["train"]["ms_per_step"]
                                     for r in ranks],
                        one_ms_per_step=one["ms_per_step"],
                        launches=launches)
    out["seconds"] = time.perf_counter() - t_phase
    return out


def nccl_world_of_one(tmp, card):
    """Phase 19 (b): ``python -m nerfool_tpu_torch.train``'s ``main`` at
    pretrain.txt's widths for 2 steps, then the same with ``--distributed``
    in a world of one rank under NCCL (the env:// variables set for the
    call): the same losses (TOL_WORLD1_LOSS)."""
    import socket
    import torch.distributed as dist
    from nerfool_tpu_torch.train.__main__ import main as train_main

    argv = ["--config", os.path.join(ROOT, "configs/ibrnet/pretrain.txt"),
            "--train_dataset", "synthetic", "--ckpt_path", "",
            "--num_source_views", "10", "--workers", "2", "--dataset_kwargs",
            json.dumps(SLICE_DATA), "--i_print", "1", "--i_weights",
            "1000000", "--no_reload", "--n_iters", "2", "--out_dir", tmp]
    plain = train_main(argv + ["--expname", "plain"])
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    env = dict(MASTER_ADDR="localhost", MASTER_PORT=port, WORLD_SIZE="1",
               RANK="0", LOCAL_RANK="0")
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        one = train_main(argv + ["--expname", "nccl", "--distributed"])
        backend, world = dist.get_backend(), dist.get_world_size()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    a = [h["loss"] for h in plain.history]
    b = [h["loss"] for h in one.history]
    rel = [abs(x - y) / abs(y) for x, y in zip(b, a)]
    ok = (backend == "nccl" and world == 1 and one.split is None
          and len(a) == len(b) == 2
          and all(r <= t for r, t in zip(rel, TOL_WORLD1_LOSS)))
    log("NCCL world of one", f"train --distributed ({backend}, world "
        f"{world}) losses {b} against the plain run's {a}: rel {rel} (tol "
        f"{list(TOL_WORLD1_LOSS)}); checkpoints "
        f"{sorted(os.listdir(os.path.join(tmp, 'nccl')))}; {card}")
    if not ok or not os.path.exists(os.path.join(tmp, "nccl",
                                                 "model_000002.pth")):
        raise AssertionError("the NCCL world of one disagrees with the "
                             "plain trainer")
    return dict(backend=backend, world=world, losses=b, plain_losses=a,
                loss_rel=rel)


def video(tmp, card):
    """Phase 19 (c): ``python -m nerfool_tpu_torch.render_video`` of
    VIDEO_FRAMES spiral frames of a 378x504 fixture LLFF scene
    (``verify_parity.make_fixture``), GNT at gnt_full.txt's widths in bf16
    through K2 and IBRNet at eval_llff.txt's per tap: K2's launches = chunks
    x frames, the PNGs' headers, seconds per frame; then the port's PNG
    reader (the loaders' reader where imageio does not import) on one
    756x1008 frame with rows in every filter: equal to what was written,
    and its seconds."""
    import numpy as np
    from nerfool_tpu_torch import render_video
    from nerfool_tpu_torch.utils.vis import read_png
    from nerfool_tpu_torch.verify_parity import make_fixture

    h, w = SLICE_DATA["h"], SLICE_DATA["w"]
    make_fixture(tmp, "ibrnet", h=h, w=w, n=VIDEO_VIEWS)
    common = ["--rootdir", tmp, "--llff_factor", "1", "--eval_dataset",
              "llff_test", "--eval_scenes", "fixscene", "--ckpt_path", "",
              "--num_source_views", "10", "--chunk_size", "4096",
              "--video_frames", str(VIDEO_FRAMES)]
    runs = {"gnt": ["--config", os.path.join(ROOT, "configs/gnt/gnt_full.txt"),
                    "--compute_dtype", "bfloat16", "--gnt_fused_chain", "on"],
            "ibrnet": ["--config",
                       os.path.join(ROOT, "configs/ibrnet/eval_llff.txt")]}
    out = {}
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        for name, flags in runs.items():
            zero_kernel_counts()
            res = render_video.main(flags + common + ["--expname", name])
            launches = kernel_counts()
            heads = [png_header(p) for p in res["frames"]]
            exp_k2 = (-(-h * w // 4096)) * VIDEO_FRAMES if name == "gnt" \
                else 0
            log("video", f"{name}: {len(res['frames'])} frames, s/frame "
                f"{res['seconds']}, PNG headers {sorted(set(heads))}, mp4 "
                f"{res['mp4']}; launches {launches} (gnt_chain expected "
                f"{exp_k2}); {card}")
            if (len(heads) != VIDEO_FRAMES
                    or set(heads) != {(w - 64, h - 64, 8, 2)}
                    or launches["gnt_chain"] != exp_k2
                    or not np.isfinite(res["seconds"]).all()):
                raise AssertionError(f"the {name} video is not as expected")
            out[name] = dict(seconds=res["seconds"], launches=launches)
    finally:
        os.chdir(cwd)
    img = np.cumsum(np.random.RandomState(0).randint(0, 9, (756, 1008, 3)),
                    axis=1).astype(np.uint8)
    path = os.path.join(tmp, "llff_frame.png")
    filtered_png(path, img)
    t0 = time.perf_counter()
    got = read_png(path)
    out["png_read_s"] = time.perf_counter() - t0
    log("video", f"read_png of a 756x1008 RGB frame, rows in all five "
        f"filters: {out['png_read_s']:.3f} s; {card}")
    if not np.array_equal(got, img):
        raise AssertionError("read_png does not undo the row filters")
    return out


def sweep_run(tmp, card):
    """Phase 19 (d): ``python -m nerfool_tpu_torch.sweep`` over the
    synthetic scene at 378x504, IBRNet at eval_llff.txt's widths, the
    view-specific attack for SWEEP_ITERS iterations on SWEEP_VIEWS views:
    the report's keys, finite PSNR / SSIM rows, seconds per scene."""
    import numpy as np
    from nerfool_tpu_torch import sweep

    argv = ["--config", os.path.join(ROOT, "configs/ibrnet/eval_llff.txt"),
            "--eval_dataset", "synthetic", "--ckpt_path", "",
            "--num_source_views", "10", "--chunk_size", "4096",
            "--view_specific", "--adv_iters", str(SWEEP_ITERS), "--use_adam",
            "--adam_lr", "1e-3", "--adv_lr", "1", "--epsilon", "8",
            "--max_views", str(SWEEP_VIEWS), "--dataset_kwargs",
            json.dumps(SLICE_DATA), "--expname", "sweep"]
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        t0 = time.perf_counter()
        report = sweep.main(argv)
        seconds = time.perf_counter() - t0
        path = os.path.join("synthetic", "sweep", "sweep_report.json")
        with open(path) as f:
            written = json.load(f)
    finally:
        os.chdir(cwd)
    scene = report["synthetic/"]
    views = [v for v in scene.values() if isinstance(v, dict)]
    vals = [v[k] for v in views for k in ("coarse_psnr", "fine_psnr",
                                          "coarse_ssim", "fine_ssim")]
    means = [scene[k] for k in ("coarse_mean_psnr", "fine_mean_psnr",
                                "coarse_mean_ssim", "fine_mean_ssim")]
    log("sweep", f"synthetic: {len(views)} views, {SWEEP_ITERS} attack "
        f"iterations each, {seconds:.2f} s/scene; means {means}; {card}")
    if (sorted(written) != ["synthetic/"] or len(views) != SWEEP_VIEWS
            or not np.isfinite(vals + means).all()):
        raise AssertionError(f"the sweep report is not as expected: {report}")
    return dict(seconds_per_scene=seconds, means=means)


def main():
    if not os.path.isdir(os.path.join(ROOT, "nerfool_tpu_torch")):
        sys.exit("chip_smoke.py must run from a checkout of the repository "
                 "(nerfool_tpu_torch/ not found beside it)")
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    # 1. device
    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    log("device", f"{kind}; count {torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; {card}")

    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.eval import parse_args
    from nerfool_tpu_torch import eval_adv, profile_attack
    from nerfool_tpu_torch.ops import (build, bspg_select, chain,
                                       ray_attention as ra,
                                       view_attention as va)

    # 2. build the four kernels, one nvcc each, in parallel
    t0 = time.perf_counter()
    build.build("bspg_select", "gnt_chain", "ray_attention", "view_attention",
                "conv2d")
    bspg_select.build()
    chain.build()
    ra.build()
    va.build()
    log("build", f"bspg_select, gnt_chain, ray_attention and view_attention "
        f"built in {time.perf_counter() - t0:.2f} s into "
        f"{os.path.relpath(build.BUILD_DIR, ROOT)}")

    # 3. plan the slice (host, numpy)
    args = parse_args(SLICE_ARGV)
    ev = Evaluator(args, dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    n_src = int(ev._make_src(ev.test_dataset[0])["cameras"].shape[0])
    if n_src != args.num_source_views:
        raise AssertionError(f"{n_src} source views, not "
                             f"{args.num_source_views}")
    t0 = time.perf_counter()
    cfg = ev.view_render_cfg(n_src)
    plan_s = time.perf_counter() - t0
    if cfg.bspg_specs is None:
        raise RuntimeError("the slice did not plan BSPG")
    spec_f, spec_r = cfg.bspg_specs
    log("plan", f"{plan_s:.2f} s host planning; feat p={spec_f.p} "
        f"groups={[(len(v), k) for v, k in spec_f.groups]}, rgb p={spec_r.p} "
        f"groups={[(len(v), k) for v, k in spec_r.groups]}")

    # 4. kernel vs plain at the slice's shapes: the chunk's blocks of every
    # view, both levels in f32 and the fine level in bf16
    bh, bw = spec_f.block
    sample_levels = (("coarse", args.N_samples),
                     ("fine", args.N_samples + args.N_importance))
    shapes = []
    for table, spec, c in (("feat", spec_f, 32), ("rgb", spec_r, 3)):
        shapes += select_shapes(spec, c, table, sample_levels,
                                (torch.float32,), n_src, args.chunk_size)
        shapes += select_shapes(spec, c, table, sample_levels[1:],
                                (torch.bfloat16,), n_src, args.chunk_size)
    checks = check_select(shapes, "ibrnet", 0, card)

    # 5. cross-device render of a small scene, same weights on both
    small = parse_args(SMALL_ARGV)
    ev_cpu = Evaluator(small, dataset_kwargs=SMALL_DATA, device="cpu", seed=0)
    ev_gpu = Evaluator(parse_args(SMALL_ARGV), dataset_kwargs=SMALL_DATA,
                       device="cuda", seed=0)
    data = ev_cpu.test_dataset[0]
    n_small = len(data["src_cameras"])
    renders = []
    with torch.inference_mode():
        for e in (ev_cpu, ev_gpu):
            ret = e.render_view(data, e._make_src(data))["outputs_coarse"]
            renders.append({k: ret[k].float().cpu().numpy()
                            for k in ("rgb", "depth", "mask")})
    torch.cuda.synchronize()
    if ev_gpu.view_render_cfg(n_small).bspg_specs is None:
        raise RuntimeError("the small scene did not plan BSPG")
    a, b = renders
    same = a["mask"] == b["mask"]
    rgb_err = float(np.abs(a["rgb"] - b["rgb"])[same].max())
    depth_err = float(np.abs(a["depth"] - b["depth"])[same].max())
    log("cross-device", f"coarse rgb max abs {rgb_err:.3g} (tol "
        f"{TOL_RGB_ABS:g}), depth max abs {depth_err:.3g} (tol "
        f"{TOL_DEPTH_ABS:g}), mask agreement {same.mean():.5f}")
    if not (same.mean() >= 0.999 and rgb_err <= TOL_RGB_ABS
            and depth_err <= TOL_DEPTH_ABS
            and np.isfinite(b["rgb"]).all() and np.isfinite(b["depth"]).all()):
        raise AssertionError("CPU and card renders disagree")
    del ev_cpu, ev_gpu

    # 6. the slice
    hp = -(-SLICE_DATA["h"] // bh) * bh  # frame padded to whole blocks
    wp = -(-SLICE_DATA["w"] // bw) * bw
    n_chunks = -(-(hp * wp) // args.chunk_size)
    levels = 2 if args.N_importance > 0 else 1
    expected = (len(spec_f.groups) + len(spec_r.groups)) * levels * n_chunks \
        * SLICE_VIEWS
    # warm-up: one render of the first test view (one-time per-shape set-up
    # of cuDNN and cuBLAS, allocator growth); its outputs must be finite
    data = ev.test_dataset[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ret = ev.render_view(data, ev._make_src(data))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for level in ("outputs_coarse", "outputs_fine"):
        for k in ("rgb", "depth", "weights"):
            if not bool(torch.isfinite(ret[level][k]).all()):
                raise AssertionError(f"non-finite {level}/{k}")
        if tuple(ret[level]["rgb"].shape) != (SLICE_DATA["h"],
                                               SLICE_DATA["w"], 3):
            raise AssertionError(f"{level} rgb shape "
                                 f"{tuple(ret[level]['rgb'].shape)}")
    del ret
    log("warm-up", f"first render {warm_s:.3f} s, outputs finite; {card}")

    bspg_select.select_taps.launches = 0
    res = ev.evaluate(max_views=SLICE_VIEWS, verbose=True)["synthetic"]
    launches = bspg_select.select_taps.launches
    rows = [v for v in res.values() if isinstance(v, dict)]
    render_s = sum(r["render_seconds"] for r in rows)
    rays = SLICE_VIEWS * SLICE_DATA["h"] * SLICE_DATA["w"]
    log("slice", f"{SLICE_VIEWS} views at {SLICE_DATA['h']}x{SLICE_DATA['w']}, "
        f"{n_src} source views, N_samples {args.N_samples} + N_importance "
        f"{args.N_importance}: bspg_select launches {launches} (expected "
        f"{expected}); planner {plan_s:.2f} s; render {render_s:.3f} s; "
        f"{rays / render_s:.1f} rays/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; coarse PSNR "
        f"{res['coarse_mean_psnr']:.4f} SSIM {res['coarse_mean_ssim']:.4f}; "
        f"fine PSNR {res['fine_mean_psnr']:.4f} SSIM "
        f"{res['fine_mean_ssim']:.4f}; {card}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    metrics = [res[k] for k in ("coarse_mean_psnr", "fine_mean_psnr",
                                "coarse_mean_ssim", "fine_mean_ssim")]
    if not np.isfinite(metrics).all():
        raise AssertionError(f"non-finite metrics {metrics}")
    ibr_launches = launches
    ibr_ab = route_ab("slice", ev, card)

    # 7. K2 against its plain version at the GNT slice's shapes
    gargs = parse_args(GNT_ARGV)
    gev = Evaluator(gargs, dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    g_src = int(gev._make_src(gev.test_dataset[0])["cameras"].shape[0])
    # the chunks K2 sees: the frame's rays padded to whole BSPG blocks, so a
    # whole chunk and a shorter last one; also the unpadded frame's last chunk
    hs = len(range(0, SLICE_DATA["h"], gargs.render_stride))
    ws = len(range(0, SLICE_DATA["w"], gargs.render_stride))
    blk = gargs.bspg_block
    g_rays_padded = -(-hs // blk) * blk * -(-ws // blk) * blk
    chunk_rays = sorted({gargs.chunk_size,
                         g_rays_padded % gargs.chunk_size or gargs.chunk_size,
                         hs * ws % gargs.chunk_size or gargs.chunk_size},
                        reverse=True)
    chain_rows = check_chain(gev.bundle.net_coarse, g_src, gargs.N_samples,
                             card, chunk_rays)

    # 8. GNT CPU-vs-card render
    gnt_errs = gnt_cross_device(card)

    # 9. the GNT slice
    t0 = time.perf_counter()
    gcfg = gev.view_render_cfg(g_src)
    g_plan_s = time.perf_counter() - t0
    if gcfg.bspg_specs is None or not gcfg.gnt_fused_chain:
        raise RuntimeError("the GNT slice did not plan BSPG with the chain")
    gbh, gbw = gcfg.bspg_specs[0].block
    if (gbh, gbw) != (blk, blk):
        raise AssertionError(f"planned {gbh}x{gbw} blocks, not {blk}x{blk}")
    g_chunks = -(-(-(-hs // gbh) * gbh * -(-ws // gbw) * gbw)
                 // gargs.chunk_size)
    g_levels = 2 if gargs.N_importance > 0 else 1
    exp_k2 = g_chunks * g_levels * GNT_VIEWS
    exp_k1 = (sum(len(sp.groups) for sp in gcfg.bspg_specs) * g_levels
              * g_chunks * GNT_VIEWS)
    log("GNT plan", f"{g_plan_s:.2f} s host planning; blocks {gbh}x{gbw}; "
        + "; ".join(f"p={sp.p} groups={[(len(v), k) for v, k in sp.groups]}"
                    for sp in gcfg.bspg_specs))
    # K1 against its plain version at the GNT slice's shapes: bf16 tables
    # (the route) and f32
    gshapes = []
    for table, spec, c in (("feat", gcfg.bspg_specs[0], 32),
                           ("rgb", gcfg.bspg_specs[1], 3)):
        gshapes += select_shapes(spec, c, table,
                                 (("coarse", gargs.N_samples),),
                                 (torch.bfloat16, torch.float32), g_src,
                                 gargs.chunk_size)
    checks += check_select(gshapes, "gnt", 100, card)
    data = gev.test_dataset[0]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        ret = gev.render_view(data, gev._make_src(data))["outputs_coarse"]
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for k, shape in (("rgb", (hs, ws, 3)), ("depth", (hs, ws)),
                     ("weights", (hs, ws, gargs.N_samples))):
        if tuple(ret[k].shape) != shape or not bool(
                torch.isfinite(ret[k]).all()):
            raise AssertionError(f"GNT warm-up {k}: shape "
                                 f"{tuple(ret[k].shape)}, finite "
                                 f"{bool(torch.isfinite(ret[k]).all())}")
    del ret
    log("GNT warm-up", f"first render {warm_s:.3f} s, outputs finite; {card}")

    torch.cuda.reset_peak_memory_stats()
    bspg_select.select_taps.launches = 0
    chain.gnt_chain.launches = 0
    gres = gev.evaluate(max_views=GNT_VIEWS, verbose=True)["synthetic"]
    k1_gnt = bspg_select.select_taps.launches
    k2_gnt = chain.gnt_chain.launches
    grows = [v for v in gres.values() if isinstance(v, dict)]
    g_render_s = sum(r["render_seconds"] for r in grows)
    g_rays = GNT_VIEWS * hs * ws
    log("GNT slice", f"{GNT_VIEWS} views at {hs}x{ws} rays (378x504, stride "
        f"{gargs.render_stride}), {g_src} source views, depth "
        f"{gargs.trans_depth}, N_samples {gargs.N_samples}, bf16: gnt_chain "
        f"launches {k2_gnt} (expected {exp_k2}), bspg_select launches {k1_gnt}"
        f" (expected {exp_k1}); planner {g_plan_s:.2f} s; render "
        f"{g_render_s:.3f} s; {g_rays / g_render_s:.1f} rays/s; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; PSNR "
        f"{gres['coarse_mean_psnr']:.4f} SSIM {gres['coarse_mean_ssim']:.4f};"
        f" {card}")
    if k2_gnt != exp_k2 or k1_gnt != exp_k1:
        raise AssertionError(f"GNT slice launches: gnt_chain {k2_gnt} != "
                             f"{exp_k2} or bspg_select {k1_gnt} != {exp_k1}")
    if not np.isfinite([gres["coarse_mean_psnr"],
                        gres["coarse_mean_ssim"]]).all():
        raise AssertionError(f"non-finite GNT metrics {gres}")

    # one view in turns through K2 and through the bf16 module path
    data = gev.test_dataset[0]
    src = gev._make_src(data)
    k2_turns = []
    for mode in ("on", "off", "off", "on"):
        gev.args.gnt_fused_chain = mode
        before = chain.gnt_chain.launches
        _, seconds = timed_render(gev, data, src, None, None)
        if (chain.gnt_chain.launches - before) != (
                g_chunks * g_levels if mode == "on" else 0):
            raise AssertionError(f"--gnt_fused_chain {mode} launched "
                                 f"{chain.gnt_chain.launches - before} chains")
        k2_turns.append((mode, hs * ws / seconds))
    gev.args.gnt_fused_chain = "auto"
    gnt_ab = route_ab("GNT slice", gev, card)
    log("GNT slice", "one view in turns, rays/s: " + ", ".join(
        f"{'K2' if m == 'on' else 'module'} {r:.1f}" for m, r in k2_turns)
        + f"; {card}")
    # the same view through K2 under the profiler: device time by kernel
    _, tables = profile_attack.profile_device(
        lambda: timed_render(gev, data, src, None, None),
        "GNT clean view through K2", 1)
    busy_ms = sum(r[0] for r in tables["kernel"])
    k2_ms = sum(r[0] for r in tables["kernel"] if "gnt_chain" in r[2])
    log("GNT slice", f"profiled view: gnt_chain {k2_ms:.1f} ms of "
        f"{busy_ms:.1f} ms device kernel time ({100 * k2_ms / busy_ms:.1f}%)"
        f"; {card}")
    if not k2_ms > 0:
        raise AssertionError("the profiled GNT view shows no gnt_chain kernel")
    del src

    # 10. K3 against its plain versions
    ra_rows, ra_times = check_ray_attention(card, sorted({
        gargs.chunk_size,
        g_rays_padded - (g_chunks - 1) * gargs.chunk_size}, reverse=True))

    # 11. the GNT attack slice, on the plan of phase 9
    aargs = eval_adv.parse_args(GNT_ATTACK_ARGV)
    aev = Evaluator(aargs, dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    aev.adopt_plan(gev)
    gnt_plan = gev
    uev = Evaluator(eval_adv.parse_args(UNI_ARGV), bundle=aev.bundle,
                    dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    uev.adopt_plan(gev)
    del gev
    depth = aargs.trans_depth
    data = aev.test_dataset[0]
    delta, src, gnt_attack = run_attack("GNT attack", aev, data, card)
    exp_iter = ATTACK_ITERS * depth
    if (gnt_attack["fwd_launches"], gnt_attack["bwd_launches"]) != (
            exp_iter, exp_iter):
        raise AssertionError(
            f"GNT attack launches: forward {gnt_attack['fwd_launches']}, "
            f"backward {gnt_attack['bwd_launches']}, expected {exp_iter} each")
    gnt_step = fused_against_unfused_step(aev, data, delta, card)
    acfg = aev.view_render_cfg(int(src["cameras"].shape[0]))
    if acfg.bspg_specs is None or not acfg.gnt_fused_attn:
        raise RuntimeError("the attacked GNT render is not on BSPG with the "
                           "fused ray attention")
    gnt_adv = attacked_render("GNT attack", aev, data, src, delta, card)
    exp_k3 = g_chunks * g_levels * depth
    exp_k1 = sum(len(sp.groups) for sp in acfg.bspg_specs) * g_levels \
        * g_chunks
    # --gnt_fused_vt auto: the attacked f32 frame takes K4 by default
    if (gnt_adv["k3_fwd_launches"], gnt_adv["k3_bwd_launches"],
            gnt_adv["k1_launches"], gnt_adv["k4_launches"]) != (
                exp_k3, 0, exp_k1, exp_k3):
        raise AssertionError(f"attacked GNT render launches {gnt_adv}, "
                             f"expected K3 and K4 {exp_k3}, K1 {exp_k1}")
    gnt_adv["attn_ab_rays_per_s"] = attn_route_ab(
        "GNT attack", aev, data, src, delta, card, exp_k3)
    gnt_bundle = aev.bundle
    del aev, delta, src

    # 12. the IBRNet attack, on the model and the plan of phase 6
    iargs = eval_adv.parse_args(IBR_ATTACK_ARGV)
    iev = Evaluator(iargs, bundle=ev.bundle, dataset_kwargs=SLICE_DATA,
                    device="cuda", seed=0)
    iev.adopt_plan(ev)
    ibr_plan = ev
    del ev
    data = iev.test_dataset[0]
    delta, src, ibr_attack = run_attack("IBRNet attack", iev, data, card)
    if ibr_attack["fwd_launches"] or ibr_attack["bwd_launches"]:
        raise AssertionError("the IBRNet attack launched the ray attention")
    ibr_adv = attacked_render("IBRNet attack", iev, data, src, delta, card)
    exp_k1 = expected // SLICE_VIEWS
    if ibr_adv["k1_launches"] != exp_k1 or ibr_adv["k4_launches"]:
        raise AssertionError(f"attacked IBRNet render launches {ibr_adv}, "
                             f"expected K1 {exp_k1} and no K4")
    ibr_bundle = iev.bundle
    del iev, delta, src

    # 13. K4 against its plain version, at the shapes of phase 14
    render_rays = sorted({gargs.chunk_size, g_rays_padded
                          - (g_chunks - 1) * gargs.chunk_size}, reverse=True)
    va_rows = check_view_attention(card, g_src, gargs.N_samples, render_rays,
                                   uev.args.N_rand)

    # 14. the universal slice, on the plan of phase 9
    ucfg = uev.view_render_cfg(g_src)
    if not (ucfg.bspg_specs is not None and ucfg.gnt_fused_vt
            and ucfg.gnt_fused_attn and not uev._grad_render_cfg().gnt_fused_vt):
        raise RuntimeError("the universal slice's render is not on BSPG with "
                           "both attention kernels")
    universal = universal_slice(
        uev, card, depth, g_chunks * g_levels,
        sum(len(sp.groups) for sp in ucfg.bspg_specs))
    del uev

    # 15. gradient surgery and the pose attack, one small iteration each
    small_modes = small_universal_modes(ibr_bundle, card)

    # 16. the defended attack: consistency terms, purification, hybrids
    defended = defended_attack(ibr_bundle, gnt_bundle, card)

    # 17. LPIPS, the image dumps, bf16 features and bf16 IBRNet
    outputs = evaluator_outputs(ibr_plan, gnt_plan, ibr_bundle, gnt_bundle,
                                card)
    split_plan = (gnt_plan._bspg_specs, gnt_plan._bspg_hw)
    del ibr_bundle, gnt_bundle, ibr_plan, gnt_plan

    # 18. the trainer: IBRNet, plain and adversarial, and GNT through K3
    train = training(card)
    gnt_train = train["gnt"]["launches"]

    # 19. the ray split on two ranks, the NCCL world of one, the video and
    # the sweep
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    split = split_paths(split_plan, depth, g_rays_padded, gargs.chunk_size,
                        card)
    with tempfile.TemporaryDirectory() as tmp:
        split["nccl_world_of_one"] = nccl_world_of_one(tmp, card)
        split["video"] = video(tmp, card)
        split["sweep"] = sweep_run(tmp, card)
    split["seconds"] = time.perf_counter() - t19
    log("split, video, sweep", f"phase took {split['seconds']:.1f} s; {card}")
    gc.collect()
    torch.cuda.empty_cache()
    conv = check_conv2d(card)
    gc.collect()
    torch.cuda.empty_cache()
    dense = check_dense(card)
    s_att, s_ren, s_tr = (split["attack"]["launches"],
                          split["render"]["launches"],
                          split["train"]["launches"])
    rank_sum = lambda runs, k: sum(x[k] for x in runs)

    bad = [m for m in sys.modules
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax")
           or m == "nerfool_tpu" or m.startswith("nerfool_tpu.")]
    if bad:
        raise AssertionError(f"modules of JAX or of the JAX package were "
                             f"imported: {bad}")

    head = next(r for r in checks if r["path"] == "ibrnet" and r["table"]
                == "feat" and r["level"] == "fine" and r["dtype"] == "f32")
    # K2's row: the whole bf16 chunk, the shape of its launches on the slice
    k2_head = next(r for r in chain_rows if r["dtype"] == "bf16"
                   and r["rays"] == gargs.chunk_size)
    for row in chain_rows:
        row["bound_ms"], row["bound_by"] = chain_bound(row)
    uni_attack, uni_render = (universal["attack_launches"],
                              universal["render_launches"])
    k1_paths = {"ibrnet": ibr_launches, "gnt": k1_gnt,
                "gnt_attacked_render": gnt_adv["k1_launches"],
                "ibrnet_attacked_render": ibr_adv["k1_launches"],
                "universal_attacked_render": uni_render["bspg_select"],
                "ibrnet_bf16_frames": outputs["ibrnet_bf16_frame"][
                    "k1_launches"],
                "split_attacked_render": rank_sum(s_ren, "bspg_select")}
    purif, hybrids = defended["purification"]["launches"], [
        defended[m]["launches"] for m in ("use_clean_density",
                                          "use_clean_color")]
    k3_fwd_paths = {"gnt_attack": gnt_attack["fwd_launches"],
                    "gnt_attacked_render": gnt_adv["k3_fwd_launches"],
                    "universal_attack": uni_attack["ray_attention_fwd"],
                    "universal_attacked_render":
                        uni_render["ray_attention_fwd"],
                    "defended_attack": purif["ray_attention_fwd"],
                    "hybrid_renders": sum(h["ray_attention_fwd"]
                                          for h in hybrids),
                    "gnt_attack_bf16_features": outputs["gnt_attack"][
                        "launches"]["bf16"]["ray_attention_fwd"],
                    "gnt_train": gnt_train["ray_attention_fwd"],
                    "split_attack": rank_sum(s_att, "ray_attention_fwd"),
                    "split_attacked_render": rank_sum(s_ren,
                                                      "ray_attention_fwd"),
                    "split_train": rank_sum(s_tr, "ray_attention_fwd")}
    k3_bwd_paths = {"gnt_attack": gnt_attack["bwd_launches"],
                    "universal_attack": uni_attack["ray_attention_bwd"],
                    "defended_attack": purif["ray_attention_bwd"],
                    "gnt_attack_bf16_features": outputs["gnt_attack"][
                        "launches"]["bf16"]["ray_attention_bwd"],
                    "gnt_train": gnt_train["ray_attention_bwd"],
                    "split_attack": rank_sum(s_att, "ray_attention_bwd"),
                    "split_train": rank_sum(s_tr, "ray_attention_bwd")}
    # the launches with the weight gradients: the training steps' alone
    k3_dw_paths = {"gnt_train": gnt_train["ray_attention_bwd_dw"],
                   "split_train": rank_sum(s_tr, "ray_attention_bwd_dw")}
    va_head = next(r for r in va_rows if r["dtype"] == "f32")  # a whole chunk
    k4_paths = {"gnt_attacked_render": gnt_adv["k4_launches"],
                "universal_attacked_render": uni_render["view_attention"],
                "hybrid_renders": sum(h["view_attention"] for h in hybrids),
                "split_attacked_render": rank_sum(s_ren, "view_attention")}
    # K5's [forward, input gradient] launches on the main paths' own runs
    # (phase 20's separate run of the feature net is under "feature_net")
    k5_of = lambda d: [d["conv2d_forward"], d["conv2d_input_grad"]]
    k5_sum = lambda ds: [sum(x) for x in zip(*map(k5_of, ds))]
    dtype_runs = {f"{n}_attack_{dt}_features": k5_of(outputs[f"{n}_attack"][
        "launches"][dt]) for n in ("ibrnet", "gnt") for dt in ("f32", "bf16")}
    k5_paths = {"gnt_attack": gnt_attack["k5_launches"],
                "ibrnet_attack": ibr_attack["k5_launches"],
                "gnt_attacked_render": gnt_adv["k5_launches"],
                "ibrnet_attacked_render": ibr_adv["k5_launches"],
                "universal_attack": k5_of(uni_attack),
                "universal_attacked_render": k5_of(uni_render),
                "defended_attack": k5_of(purif),
                "hybrid_renders": k5_sum(hybrids), **dtype_runs,
                "ibrnet_train": train["ibrnet"]["k5_launches"],
                "ibrnet_adv_train": train["ibrnet_adv"]["k5_launches"],
                "gnt_train": k5_of(gnt_train),
                "split_attack": k5_sum(s_att),
                "split_attacked_render": k5_sum(s_ren),
                "split_train": k5_sum(s_tr),
                "video": k5_sum(split["video"][n]["launches"]
                                for n in ("gnt", "ibrnet"))}
    ra_f32 = ra_times["f32"]
    ra_errs = next(r["errs"] for r in ra_rows if r["shape"] == "slice"
                   and r["dtype"] == "f32" and r["cotangent"] == "out+attn0")
    ra_chunk = next(r for r in ra_rows if "ms" in r)
    ra_source = "nerfool_tpu_torch/csrc/ray_attention.cu"
    # no single PyTorch call computes any of these functions (a one-hot
    # gather of patch taps; a whole transformer chain; an attention that
    # also returns a row of its softmax, and its backward; a per-channel
    # subtraction attention over views): library_ms null
    print(card)
    print(json.dumps({"kernels": [{
        "name": "bspg_select", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/bspg_select.cu",
        "replaces": "nerfool_tpu/ops/bspg_kernel.py:387",
        "launches": sum(k1_paths.values()),
        "launches_by_path": k1_paths,
        "max_abs_err": max(r["max_abs_err"] for r in checks
                           if r["dtype"] == "f32"),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "bound_old_ms": head["bound_old_ms"],
        "library_ms": None, "shapes": checks + outputs["k1_bf16"],
        "route_ab_rays_per_s": {"ibrnet": ibr_ab, "gnt": gnt_ab}}, {
        "name": "gnt_chain", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/gnt_chain.cu",
        "replaces": "nerfool_tpu/ops/chain_kernel.py:220",
        "launches": k2_gnt + split["video"]["gnt"]["launches"]["gnt_chain"],
        "launches_by_path": {"gnt": k2_gnt, "video": split["video"]["gnt"][
            "launches"]["gnt_chain"]},
        "max_abs_err": k2_head["max_abs_err"],
        "f32_max_abs_err": chain_rows[0]["max_abs_err"],
        "ms": k2_head["ms"], "plain_ms": k2_head["plain_ms"],
        "bound_ms": k2_head["bound_ms"], "bound_by": k2_head["bound_by"],
        "library_ms": None,
        "shapes": chain_rows, "render_errors": gnt_errs,
        "slice_rays_per_s": g_rays / g_render_s,
        "render_ab_rays_per_s": k2_turns,
        "profiled_view": {"gnt_chain_ms": k2_ms, "device_kernel_ms": busy_ms}},
        {
        "name": "ray_attention_fwd", "route": "cuda", "source": ra_source,
        "replaces": "nerfool_tpu/ops/ra_kernel.py:80",
        "launches": sum(k3_fwd_paths.values()),
        "launches_by_path": k3_fwd_paths,
        "max_abs_err": max(ra_errs["out"], ra_errs["attn0"]),
        "ms": ra_f32["fwd_ms"], "plain_ms": ra_f32["plain_fwd_ms"],
        "bound_ms": ra_f32["fwd_bound_ms"],
        "bound_by": ra_f32["fwd_bound_by"],
        "bound_fma_ms": ra_f32["fwd_bound_one_rate_ms"],
        "library_ms": None,
        "render_chunk": {k: ra_chunk[k] for k in (
            "rays", "ms", "plain_ms", "bound_ms", "bound_by",
            "bound_fma_ms")},
        "resources": ra_f32["fwd_resources"],
        "render_ab_rays_per_s": gnt_adv["attn_ab_rays_per_s"],
        "shapes": ra_rows, "times": ra_times}, {
        "name": "ray_attention_bwd", "route": "cuda", "source": ra_source,
        "replaces": "nerfool_tpu/ops/ra_kernel.py:198",
        "launches": sum(k3_bwd_paths.values()),
        "launches_by_path": k3_bwd_paths,
        "max_abs_err": max(ra_errs[n] for n in ("dx", "dx_no_dw", "dwqkv",
                                               "dwo", "dbo")),
        "ms": ra_f32["bwd_no_dw_ms"], "plain_ms": ra_f32["plain_bwd_ms"],
        "bound_ms": ra_f32["bwd_no_dw_bound_ms"],
        "bound_by": ra_f32["bwd_no_dw_bound_by"],
        "bound_fma_ms": ra_f32["bwd_bound_one_rate_ms"],
        "dw_launches": sum(k3_dw_paths.values()),
        "dw_launches_by_path": k3_dw_paths,
        "dw_ms": ra_f32["bwd_ms"], "dw_bound_ms": ra_f32["bwd_bound_ms"],
        "dw_shape": list(RA_SHAPE),
        "resources": ra_f32["bwd_resources"], "library_ms": None}, {
        "name": "view_attention", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/view_attention.cu",
        "replaces": "nerfool_tpu/ops/vt_kernel.py:126",
        "launches": sum(k4_paths.values()),
        "launches_by_path": k4_paths,
        "max_abs_err": max(r["max_abs_err"] for r in va_rows
                           if r["dtype"] == "f32"),
        "ms": va_head["ms"], "plain_ms": va_head["plain_ms"],
        "bound_ms": va_head["bound_ms"], "bound_by": va_head["bound_by"],
        "bound_fma_ms": va_head["bound_fma_ms"],
        "library_ms": None, "shapes": va_rows}, {
        "name": "conv2d", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/conv2d.cu", "replaces": None,
        "launches": sum(map(sum, k5_paths.values())),
        "launches_by_path": k5_paths,
        "max_rel_err": max(conv["sums"]["worst_fwd_err"],
                           conv["sums"]["worst_bwd_err"]),
        "ms": conv["sums"]["k5_ms"], "plain_ms": conv["sums"]["plain_ms"],
        "bound_ms": conv["sums"]["bound_both_ms"], "bound_by": "operations",
        "library_ms": conv["sums"]["library_ms"], "shapes": conv["rows"],
        "feature_net": conv["feature_net"]}, {
        "name": "linear", "route": "cuda",
        "source": "nerfool_tpu_torch/csrc/linear.cu", "replaces": None,
        "launches": sum(dense["attack"]["launches"].values()),
        "launches_by_path": {"pixelnerf_attack": dense["attack"]["launches"],
                             "pixelnerf_frame": dense["frame"]["launches"],
                             "pixelnerf_train": dense["trainer"]["launches"]},
        "max_rel_err": dense["worst_err"],
        "ms": sum(r["ms"] for r in dense["rows"]),
        "plain_ms": sum(r["plain_ms"] for r in dense["rows"]),
        "bound_ms": sum(r["bound_ms"] for r in dense["rows"]),
        "bound_by": "operations",
        "library_ms": sum(r["library_ms"] for r in dense["rows"]),
        "shapes": dense["rows"], "attack": dense["attack"],
        "frame": dense["frame"], "trainer": dense["trainer"],
        "train": dense["train"]}],
        "attack": {"gnt": {**gnt_attack, **gnt_step, "render": gnt_adv},
                   "ibrnet": {**ibr_attack, "render": ibr_adv},
                   "universal": universal, "small_modes": small_modes,
                   "defended": defended},
        "evaluator_outputs": outputs, "training": train,
        "split_video_sweep": split}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


# ---- phase 20: K5, the feature net's convolutions ----

# the attack's feature net input: ten source views at LLFF's 756x1008
CONV_VIEWS, CONV_HW = 10, (756, 1008)
CONV_REPS = 5


def conv_images(v, h, w, seed):
    """Image-like inputs in [0, 1]: smooth colour fields (bicubic from a
    24x32 draw) with a little pixel noise. :return: [V, H, W, 3]"""
    import torch
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(seed)
    low = torch.rand(v, 3, 24, 32, device="cuda", generator=gen)
    x = F.interpolate(low, size=(h, w), mode="bicubic", align_corners=False)
    x = x + 0.02 * torch.randn(x.shape, device="cuda", generator=gen)
    return x.clamp(0, 1).permute(0, 2, 3, 1).contiguous()


def resunet_convs(net, x):
    """The distinct convolutions of ``net``'s forward on ``x``: (c_in,
    c_out, k, stride, pad, bias, h_in, w_in) -> count, the input size before
    the pad."""
    import torch
    from nerfool_tpu_torch.models.layers import Conv2d

    seen = {}

    def hook(mod, inp, _out):
        _, c, h, w = inp[0].shape
        key = (c, mod.out_channels, mod.kernel_size[0], mod.stride[0],
               mod.padding[0], mod.bias is not None, h, w)
        seen[key] = seen.get(key, 0) + 1

    hooks = [m.register_forward_hook(hook) for m in net.modules()
             if isinstance(m, Conv2d)]
    with torch.no_grad():
        net(x)
    for hk in hooks:
        hk.remove()
    return seen


def conv_flops(v, c, n, k, ho, wo):
    return 2 * v * ho * wo * n * c * k * k


@contextlib.contextmanager
def library_convs():
    """The feature net's convolutions through the library's ``F.conv2d``
    (cuDNN, TF32 off), as before K5, while the block runs."""
    from nerfool_tpu_torch.ops import conv2d

    takes = conv2d.takes
    conv2d.takes = lambda x: False
    try:
        yield
    finally:
        conv2d.takes = takes


def feature_net_distances(name, net, x, seed):
    """The feature net's maps and input gradient (the VJP of a seeded
    normal cotangent) through K5 and through the library's route, each
    against the same in float64: the largest deviation as a share of
    float64's largest entry, and the relative L2. Also the K5 launches of
    one forward and backward."""
    import copy
    import torch
    from nerfool_tpu_torch.ops import conv2d

    def route(m, xx, cot):
        xx = xx.detach().requires_grad_(True)
        coarse, fine = m(xx)
        maps = coarse if fine is None or fine is coarse else torch.cat(
            [coarse, fine], dim=-1)
        g, = torch.autograd.grad(maps, xx, cot)
        return maps.detach().double().reshape(-1), g.double().reshape(-1)

    with torch.no_grad():
        c0, f0 = net(x[:1])
    width = c0.shape[-1] + (0 if f0 is None or f0 is c0 else f0.shape[-1])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    cot = torch.randn((x.shape[0],) + tuple(c0.shape[1:-1]) + (width,),
                      device="cuda", generator=gen)
    net64 = copy.deepcopy(net).double()
    ref = route(net64, x.double(), cot.double())
    del net64
    torch.cuda.empty_cache()
    before = (conv2d.conv2d_forward.launches,
              conv2d.conv2d_input_grad.launches)
    kern = route(net, x, cot)
    launches = (conv2d.conv2d_forward.launches - before[0],
                conv2d.conv2d_input_grad.launches - before[1])
    with library_convs():
        lib = route(net, x, cot)
    norm = torch.linalg.norm
    out = {"launches_forward": launches[0],
           "launches_input_grad": launches[1]}
    for i, what in enumerate(("maps", "vjp")):
        r = ref[i]
        dev = lambda a: (float((a - r).abs().max() / r.abs().max()),
                         float(norm(a - r) / norm(r)))
        out[what] = {"k5_vs_f64": dev(kern[i]), "library_vs_f64": dev(lib[i])}
    log("K5 feature net", f"{name}: {json.dumps(out)}")
    return out


def feature_net_turns(net, x, seed, reps=3):
    """ms of the feature net's forward and input gradient (no parameter
    gradients, as in the attack) through K5 and through the library's
    route, in turns (K5, library, library, K5)."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        c0, f0 = net(x[:1])
    width = c0.shape[-1] + (0 if f0 is None or f0 is c0 else f0.shape[-1])
    cot = torch.randn((x.shape[0],) + tuple(c0.shape[1:-1]) + (width,),
                      device="cuda", generator=gen)

    def step():
        xx = x.detach().requires_grad_(True)
        coarse, fine = net(xx)
        maps = coarse if fine is None or fine is coarse else torch.cat(
            [coarse, fine], dim=-1)
        torch.autograd.grad(maps, xx, cot)

    times = {"k5": [], "library": []}
    for which in ("k5", "library", "library", "k5"):
        if which == "library":
            with library_convs():
                times[which].append(time_ms(step, reps))
        else:
            times[which].append(time_ms(step, reps))
    return times


def check_conv2d(card):
    """Phase 20: K5 (``ops/conv2d.py``) at the attack's shapes, ten views
    at 756x1008 through IBRNet's ResUNet (coarse and fine heads, 64
    channels out; GNT's single head differs only in the last two
    convolutions' width, measured too). Every distinct convolution: the
    kernel's forward and input gradient against float64, beside the plain
    version (cuDNN's f32, TF32 off) and the library's own input gradient
    (``aten::convolution_backward``, what autograd ran before K5); their ms
    by CUDA events, the kernel's in turns with the library's, summed over
    the convolutions with their counts, beside the bound (operations as
    three TF32 products at 495 TFLOP/s). Then the whole feature net's
    maps and input gradient against float64 through both routes, with the
    launches of one forward and backward (35 and 35), and its ms through
    both routes in turns."""
    import torch
    from nerfool_tpu_torch.models.bundle import _seeded_init_
    from nerfool_tpu_torch.models.resunet import ResUNet
    from nerfool_tpu_torch.ops import conv2d

    t0 = time.perf_counter()
    conv2d.build()
    log("K5 build", f"csrc/conv2d.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    v, (h, w) = CONV_VIEWS, CONV_HW
    x = conv_images(v, h, w, seed=5)
    nets = {}
    for name, kw in (("ibrnet", {}), ("gnt", {"single_net": True})):
        gen = torch.Generator().manual_seed(3)
        net = ResUNet(32, 32, **kw)
        _seeded_init_(net, gen)
        nets[name] = net.cuda()
    shapes = resunet_convs(nets["ibrnet"], x)
    for key, count in resunet_convs(nets["gnt"], x).items():
        if key not in shapes:
            shapes[key] = 0  # GNT's head only: checked, not in the sums
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(7)
    aten_bwd = torch.ops.aten.convolution_backward
    for (c, n, k, s, pad, has_b, hi, wi), count in sorted(shapes.items()):
        hp, wp = hi + 2 * pad, wi + 2 * pad
        ho, wo = (hp - k) // s + 1, (wp - k) // s + 1
        xp = torch.randn(v, c, hp, wp, device="cuda", generator=gen)
        bound = 1 / math.sqrt(c * k * k)
        wt = (torch.rand(n, c, k, k, device="cuda", generator=gen) * 2 - 1) \
            * bound
        b = ((torch.rand(n, device="cuda", generator=gen) * 2 - 1) * bound
             if has_b else None)
        dy = torch.randn(v, n, ho, wo, device="cuda", generator=gen)
        fwd = lambda: conv2d.conv2d_forward(xp, wt, b, s)
        bwd = lambda: conv2d.conv2d_input_grad(dy, wt, hp, wp, s)
        lib_fwd = lambda: conv2d.conv2d_plain(xp, wt, b, s)
        lib_bwd = lambda: aten_bwd(dy, xp, wt, None, [s, s], [0, 0], [1, 1],
                                   False, [0, 0], 1, [True, False, False])[0]
        plain_bwd = lambda: conv2d.conv2d_input_grad_plain(dy, wt, hp, wp, s)
        y, gx = fwd(), bwd()
        torch.cuda.synchronize()
        y64 = conv2d.conv2d_plain(xp.double(), wt.double(),
                                  None if b is None else b.double(), s)
        g64 = conv2d.conv2d_input_grad_plain(dy.double(), wt.double(), hp, wp,
                                             s)
        rel = lambda a, r: float((a.double() - r).abs().max()
                                 / r.abs().max())
        row = {"c_in": c, "c_out": n, "k": k, "stride": s, "pad": pad,
               "bias": has_b, "in_hw": [hi, wi], "count": count,
               "fwd_err": rel(y, y64), "lib_fwd_err": rel(lib_fwd(), y64),
               "bwd_err": rel(gx, g64), "lib_bwd_err": rel(lib_bwd(), g64),
               "plain_bwd_err": rel(plain_bwd(), g64)}
        del y64, g64, y, gx
        ms = {"fwd": [], "bwd": [], "lib_fwd": [], "lib_bwd": []}
        for turn in ("k5", "lib", "lib", "k5"):
            if turn == "k5":
                ms["fwd"].append(time_ms(fwd, CONV_REPS))
                ms["bwd"].append(time_ms(bwd, CONV_REPS))
            else:
                ms["lib_fwd"].append(time_ms(lib_fwd, CONV_REPS))
                ms["lib_bwd"].append(time_ms(lib_bwd, CONV_REPS))
        row.update({f"{k2}_ms": sum(t) / len(t) for k2, t in ms.items()})
        row["plain_bwd_ms"] = time_ms(plain_bwd, CONV_REPS)
        flops = conv_flops(v, c, n, k, ho, wo)
        row["bound_ms"] = 3 * flops / PEAK_FLOPS["tf32"] * 1e3
        rows.append(row)
        log("K5 conv", json.dumps(row))
        del xp, wt, b, dy
        torch.cuda.empty_cache()
    tot = lambda key: sum(r[key] * r["count"] for r in rows)
    sums = {key: tot(key) for key in ("fwd_ms", "bwd_ms", "lib_fwd_ms",
                                       "lib_bwd_ms", "plain_bwd_ms",
                                       "bound_ms")}
    sums["convolutions"] = sum(r["count"] for r in rows)
    sums["bound_both_ms"] = 2 * sums["bound_ms"]
    sums["k5_ms"] = sums["fwd_ms"] + sums["bwd_ms"]
    sums["library_ms"] = sums["lib_fwd_ms"] + sums["lib_bwd_ms"]
    sums["plain_ms"] = sums["lib_fwd_ms"] + sums["plain_bwd_ms"]
    sums["k5_share_of_bound"] = sums["bound_both_ms"] / sums["k5_ms"]
    sums["worst_fwd_err"] = max(r["fwd_err"] for r in rows)
    sums["worst_bwd_err"] = max(r["bwd_err"] for r in rows)
    sums["worst_lib_fwd_err"] = max(r["lib_fwd_err"] for r in rows)
    sums["worst_lib_bwd_err"] = max(r["lib_bwd_err"] for r in rows)
    log("K5 sums", f"{json.dumps(sums)}; {card}")
    nets_out = {}
    for name, net in nets.items():
        d = feature_net_distances(name, net, x, seed=11)
        d["ms_turns"] = feature_net_turns(net, x, seed=13)
        log("K5 feature net ms", f"{name}: {json.dumps(d['ms_turns'])}; "
            f"{card}")
        nets_out[name] = d
        torch.cuda.empty_cache()
    bad = [n for n, d in nets_out.items()
           if (d["launches_forward"], d["launches_input_grad"]) != (35, 35)]
    if bad:
        raise AssertionError(f"K5 launches of one forward and backward are "
                             f"not 35 and 35: {bad}")
    if sums["worst_fwd_err"] > 1e-5 or sums["worst_bwd_err"] > 1e-5:
        raise AssertionError(f"K5 lies farther from float64 than 1e-5 of "
                             f"the output's scale: {sums}")
    return {"rows": rows, "sums": sums, "feature_net": nets_out}


# ---- phase 21: K6, pixelNeRF's ResnetFC products ----

# the pixelNeRF attack cell's shapes: 10 sources, 512 rays, 64 coarse and
# 64 + 16 + 16 fine samples, 512 wide
DENSE_VIEWS, DENSE_RAYS, DENSE_WIDTH = 10, 512, 512
DENSE_SAMPLES = {"coarse": 64, "fine": 96}
# the pixelNeRF attack and frame of the phase: the cell's flags on the
# synthetic slice (378x504, 10 sources), 1 + DENSE_ITERS iterations a route
DENSE_ITERS = 3
PIXELNERF_ARGV = [
    "--eval_dataset", "synthetic", "--backbone", "pixelnerf", "--ckpt_path",
    "", "--num_source_views", "10", "--N_samples", "64", "--N_importance",
    "16", "--pixelnerf_n_depth", "16", "--chunk_size", "4096",
    "--view_specific", "--use_adam", "--adam_lr", "1e-3", "--adv_lr", "1",
    "--epsilon", "8", "--N_rand", "512"]
# K6 launches of one attack iteration: each of two nets runs COMBINE_LAYER
# per-view blocks of three and N_BLOCKS - COMBINE_LAYER pooled blocks of
# two, forward and input gradient alike; a frame's chunk runs the forwards
K6_STEP = 26


def check_dense(card):
    """Phase 21: K6 (``ops/linear.py``) at the pixelNeRF attack cell's
    shapes: ``lin_z`` on the coarse level's taps (the transposed view,
    M-major) with the block input as addend, ``fc_1`` on the fine level's
    rows (ReLU, bias, addend), the input gradients of ``fc_0`` (ReLU mask,
    addend) and of ``lin_z``, each against float64 beside the plain version
    (cuBLAS's f32, TF32 off); their ms by CUDA events in turns with the
    plain version's, and ``torch.matmul``'s product alone (``library_ms``),
    beside the bound (operations as three TF32 products at 495 TFLOP/s).
    Then the pixelNeRF attack on the synthetic slice through K6 and through
    the module's layers in turns (its launches, ms an iteration, the first
    step's loss and gradient), one frame through ``Evaluator.render_view``
    (launches and the coarse rgb through both routes), three steps of the
    trainer (launches, losses), and one ResnetFC forward and backward with
    the parameters requiring gradients against float64."""
    import torch
    from nerfool_tpu_torch import eval_adv
    from nerfool_tpu_torch.attack.attack import (init_attack_state,
                                                 make_attack_step,
                                                 select_ray_indices)
    from nerfool_tpu_torch.engine import Evaluator, build_attack_config
    from nerfool_tpu_torch.models import pixelnerf
    from nerfool_tpu_torch.ops import linear

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    linear.build()
    log("K6 build", f"csrc/linear.cu built and loaded in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(21)
    n = DENSE_WIDTH
    rel = lambda a, r: float((a.double() - r).abs().max() / r.abs().max())
    rows = []
    for level, samples in DENSE_SAMPLES.items():
        p = DENSE_RAYS * samples
        m = DENSE_VIEWS * p
        randn = lambda *shape: torch.randn(*shape, device="cuda",
                                           generator=gen)
        taps = randn(DENSE_VIEWS, n, p).transpose(1, 2)
        h, h2, g, g2 = (randn(DENSE_VIEWS, p, n) for _ in range(4))
        w = randn(n, n) / math.sqrt(n)
        b = randn(n)
        d64 = lambda t: t.double() if torch.is_tensor(t) else t
        cases = {
            "lin_z": (linear.dense_forward, linear.dense_plain,
                      (taps, w, b, h, False), taps),
            "fc_1": (linear.dense_forward, linear.dense_plain,
                     (h, w, b, h2, True), h),
            "fc_0 input gradient": (
                linear.dense_input_grad, linear.dense_input_grad_plain,
                (g, w, h, g2), g),
            "lin_z input gradient": (
                linear.dense_input_grad, linear.dense_input_grad_plain,
                (g, w, None, None), g)}
        for name, (kernel, plain, args, a) in cases.items():
            ref = plain(*map(d64, args))
            err, lib_err = rel(kernel(*args), ref), rel(plain(*args), ref)
            del ref
            wt = w.t() if kernel is linear.dense_forward else w
            ms = {"k6": [], "plain": []}
            for route in ("k6", "plain", "plain", "k6"):
                fn = kernel if route == "k6" else plain
                ms[route].append(time_ms(lambda: fn(*args), 10))
            library = time_ms(lambda: torch.matmul(a, wt), 10)
            bound = 3 * 2 * m * n * n / PEAK_FLOPS["tf32"] * 1e3
            row = dict(level=level, product=name, rows=m, k6_err=err,
                       cublas_err=lib_err, ms=min(ms["k6"]),
                       ms_turns=ms["k6"], plain_ms=min(ms["plain"]),
                       library_ms=library, bound_ms=bound,
                       share=bound / min(ms["k6"]))
            rows.append(row)
            log("K6", f"{level} {name}, {m} rows: {row['ms']:.3f} ms "
                f"({100 * row['share']:.1f}% of {bound:.3f}), plain "
                f"{row['plain_ms']:.3f}, torch.matmul {library:.3f}; "
                f"from float64 {err:.2e} (cuBLAS f32 {lib_err:.2e}); {card}")
            if err > 2 * lib_err:
                raise AssertionError(f"K6 {level} {name}: {err:.3e} from "
                                     f"float64, over twice cuBLAS's "
                                     f"{lib_err:.3e}")
        del taps, h, h2, g, g2
        torch.cuda.empty_cache()

    # the attack and a frame, through K6 and the module's layers in turns
    ev = Evaluator(eval_adv.parse_args(PIXELNERF_ARGV),
                   dataset_kwargs=SLICE_DATA, device="cuda", seed=0)
    d = ev.test_dataset[0]
    tgt, (hh, ww) = ev._make_target(d)
    src = ev._make_src(d)
    cfg = build_attack_config(ev.args, hh, ww)
    step = make_attack_step(ev.bundle, ev._grad_render_cfg(), cfg)
    takes = linear.takes

    def attack():
        g0 = torch.Generator(device="cuda").manual_seed(7)
        state = init_attack_state(g0, cfg, src["rgbs"])
        for i in range(DENSE_ITERS + 1):
            if i == 1:
                torch.cuda.synchronize()
                zero_kernel_counts()
                t1 = time.perf_counter()
            sel = select_ray_indices(g0, cfg, "cuda")
            state, aux = step(state, tgt, src, sel=sel, generator=g0)
            if i == 0:
                first = dict(loss=float(aux["loss"]), g=state["m"] / -0.1)
        torch.cuda.synchronize()
        return dict(first, ms_per_iter=(time.perf_counter() - t1)
                    / DENSE_ITERS * 1e3, launches=kernel_counts())

    def frame():
        ev.generator.manual_seed(11)
        zero_kernel_counts()
        with torch.inference_mode():
            out = ev.render_view(d, src)
        torch.cuda.synchronize()
        return out, kernel_counts()

    runs = {}
    for route in ("k6", "layers", "layers", "k6"):
        linear.takes = takes if route == "k6" else (
            lambda t: t.device.type != "cuda" and takes(t))
        try:
            runs.setdefault(route, []).append(attack())
        finally:
            linear.takes = takes
    k6, lay = runs["k6"][0], runs["layers"][0]
    want = {"dense_forward": K6_STEP * DENSE_ITERS,
            "dense_input_grad": K6_STEP * DENSE_ITERS}
    got = {k: k6["launches"][k] for k in want}
    if got != want or any(r["launches"][k] for r in runs["layers"]
                          for k in want):
        raise AssertionError(f"K6 launches in {DENSE_ITERS} pixelNeRF "
                             f"attack iterations {got}, not {want}; the "
                             f"layers' route {runs['layers'][0]['launches']}")
    g_rel = float((k6["g"] - lay["g"]).norm() / lay["g"].norm())
    attack_out = dict(
        ms_per_iter={r: [x["ms_per_iter"] for x in runs[r]] for r in runs},
        loss={"k6": k6["loss"], "layers": lay["loss"]},
        grad_rel_l2=g_rel, launches=got)
    log("K6 attack", f"pixelNeRF, 378x504, 10 sources, N_rand 512: "
        f"{attack_out['ms_per_iter']} ms/iter (K6, layers in turns); loss "
        f"{k6['loss']:.6f} / {lay['loss']:.6f}; first gradient relative L2 "
        f"{g_rel:.2e}; launches {got}; {card}")
    if not math.isfinite(g_rel):
        raise AssertionError(f"K6's first attack gradient: {g_rel}")

    ev.args.render_stride = 4
    out_k6, launches = frame()
    linear.takes = lambda t: t.device.type != "cuda" and takes(t)
    try:
        out_lay, lay_launches = frame()
    finally:
        linear.takes = takes
    rgb, rgb_lay = out_k6["outputs_coarse"]["rgb"], out_lay[
        "outputs_coarse"]["rgb"]
    rays = rgb.numel() // 3
    chunks = -(-rays // ev.args.chunk_size)
    frame_out = dict(rays=rays, chunks=chunks,
                     launches=launches["dense_forward"],
                     input_grad_launches=launches["dense_input_grad"],
                     coarse_rgb_max_diff=float((rgb - rgb_lay).abs().max()),
                     finite=bool(torch.isfinite(rgb).all()))
    log("K6 frame", f"Evaluator.render_view at render_stride 4: {frame_out}"
        f"; {card}")
    if (frame_out["launches"] != K6_STEP * chunks
            or frame_out["input_grad_launches"] or not frame_out["finite"]
            or lay_launches["dense_forward"]):
        raise AssertionError(f"K6 frame: {frame_out}, the layers' route "
                             f"{lay_launches}")
    del ev, step, src, tgt
    torch.cuda.empty_cache()

    # the trainer: DENSE_ITERS steps of pixelNeRF at the slice's size
    from nerfool_tpu_torch.train.__main__ import main as train_main

    zero_kernel_counts()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = train_main([
            "--train_dataset", "synthetic", "--device", "cuda", "--backbone",
            "pixelnerf", "--ckpt_path", "", "--n_iters", str(DENSE_ITERS),
            "--N_samples", "64", "--N_importance", "16",
            "--pixelnerf_n_depth", "16", "--num_source_views", "10",
            "--N_rand", "512", "--workers", "0", "--no_reload", "--i_img",
            "0", "--i_weights", "1000", "--i_print", "1", "--out_dir", tmp,
            "--dataset_kwargs", json.dumps(SLICE_DATA)])
    counts = kernel_counts()
    losses = [h["loss"] for h in trainer.history]
    trained = dict(losses=losses, launches={
        k: counts[k] for k in ("dense_forward", "dense_input_grad")})
    log("K6 trainer", f"pixelNeRF, {DENSE_ITERS} steps at 378x504 with 10 "
        f"sources, N_rand 512: {trained}; {card}")
    if (trained["launches"] != {"dense_forward": K6_STEP * DENSE_ITERS,
                                "dense_input_grad": K6_STEP * DENSE_ITERS}
            or len(losses) != DENSE_ITERS
            or not all(map(math.isfinite, losses))):
        raise AssertionError(f"K6 trainer: {trained}")
    del trainer
    torch.cuda.empty_cache()

    # what a training step asks of ResnetFC: every parameter's gradient
    torch.manual_seed(3)
    net = pixelnerf.ResnetFC(DENSE_WIDTH).cuda()
    p = DENSE_RAYS * 8
    taps = torch.randn(DENSE_VIEWS, pixelnerf.LATENT, p, device="cuda",
                       generator=gen).transpose(1, 2).reshape(
        DENSE_VIEWS, DENSE_RAYS, 8, pixelnerf.LATENT).requires_grad_(True)
    x_in = torch.randn(DENSE_VIEWS, DENSE_RAYS, 8, pixelnerf.D_IN,
                       device="cuda", generator=gen)
    cot = torch.randn(DENSE_RAYS, 8, 4, device="cuda", generator=gen)

    def grads(module, dtype):
        out = module(taps.to(dtype), x_in.to(dtype))
        return torch.autograd.grad((out * cot.to(dtype)).sum(),
                                   [taps] + list(module.parameters()))

    got = grads(net, torch.float32)
    linear.takes = lambda t: t.device.type != "cuda" and takes(t)
    try:
        lay = grads(net, torch.float32)
        want = grads(net.double(), torch.float64)
    finally:
        linear.takes = takes
    # largest error as a share of the largest entry, and relative L2: a
    # ReLU whose input lies within rounding of 0 takes another branch in
    # f32 than in float64 now and then, and moves a weight gradient's row
    # by ~1e-4 of its scale on either route
    l2 = lambda a, r: float((a.double() - r).norm() / r.norm())
    names = ["latent"] + [k for k, _ in net.named_parameters()]
    errs = {k: {"k6": (rel(a, c), l2(a, c)), "layers": (rel(b, c), l2(b, c))}
            for k, a, b, c in zip(names, got, lay, want)}
    worst = max(errs, key=lambda k: errs[k]["k6"][1])
    train = {"grad_err": errs, "worst": worst}
    log("K6 train step", f"ResnetFC forward and backward with every "
        f"parameter's gradient, {DENSE_VIEWS} x {p} rows, against float64: "
        f"worst relative L2 {worst} {errs[worst]} (K6, the layers' cuBLAS "
        f"f32: largest entry share, relative L2); {card}")
    if errs[worst]["k6"][1] > 1e-3:
        raise AssertionError(f"K6 train step: {worst} {errs[worst]}")
    return {"rows": rows, "attack": attack_out, "frame": frame_out,
            "trainer": trained, "train": train,
            "worst_err": max(r["k6_err"] for r in rows)}


def dense_alone():
    """Phase 21 alone: ``python3 chip_smoke.py --dense-only``; prints its
    readings as one JSON line."""
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    card = card_line()
    log("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; {card}")
    out = check_dense(card)
    print(json.dumps({"card": card, "dense": out}))


def conv_alone():
    """Phase 20 alone: ``python3 chip_smoke.py --conv-only``; prints its
    readings as one JSON line."""
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    card = card_line()
    log("device", f"{torch.cuda.get_device_name(0)}; torch "
        f"{torch.__version__} cuda {torch.version.cuda}; {card}")
    out = check_conv2d(card)
    print(json.dumps({"card": card, "conv2d": out}))


def split_alone(root):
    """Phase 19 (a) alone, as the ``chip_smoke.py`` at ``root`` runs it
    with its own package: the kernels built, the GNT slice's plan of phase
    9 made, then that script's ``split_paths``; prints its readings as one
    JSON line. Run as ``python3 chip_smoke.py --split-only [ROOT]`` (ROOT:
    this checkout by default). To compare two trees on one card, unpack
    the other into the gitignored ``ab_trees/`` and run both in turns
    (``--split-only ab_trees/<tree>``, ``--split-only``, ...), each in its
    own process."""
    import importlib.util

    root = os.path.abspath(root)
    spec = importlib.util.spec_from_file_location(
        "tree_chip_smoke", os.path.join(root, "chip_smoke.py"))
    tree = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tree)
    sys.path.insert(0, root)
    import torch
    from nerfool_tpu_torch.engine import Evaluator
    from nerfool_tpu_torch.eval import parse_args
    from nerfool_tpu_torch.ops import build

    if not torch.cuda.is_available():
        sys.exit("no CUDA device: torch.cuda.is_available() is False")
    card = tree.card_line()
    build.build("bspg_select", "gnt_chain", "ray_attention", "view_attention")
    gargs = parse_args(tree.GNT_ARGV)
    gev = Evaluator(gargs, dataset_kwargs=tree.SLICE_DATA, device="cuda",
                    seed=0)
    gev.view_render_cfg(int(gev._make_src(gev.test_dataset[0])[
        "cameras"].shape[0]))
    hs = len(range(0, tree.SLICE_DATA["h"], gargs.render_stride))
    ws = len(range(0, tree.SLICE_DATA["w"], gargs.render_stride))
    blk = gargs.bspg_block
    t0 = time.perf_counter()
    out = tree.split_paths((gev._bspg_specs, gev._bspg_hw),
                           gargs.trans_depth,
                           -(-hs // blk) * blk * -(-ws // blk) * blk,
                           gargs.chunk_size, card)
    log("split alone", f"{root}: {time.perf_counter() - t0:.1f} s; {card}")
    print(json.dumps({"root": root, "split": out}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--split-rank"]:
        split_rank(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
                   sys.argv[5])
    elif sys.argv[1:2] == ["--conv-only"]:
        conv_alone()
    elif sys.argv[1:2] == ["--dense-only"]:
        dense_alone()
    elif sys.argv[1:2] == ["--split-only"]:
        split_alone(sys.argv[2] if len(sys.argv) > 2 else ROOT)
    else:
        main()
