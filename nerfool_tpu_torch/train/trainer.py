"""Backbone trainer (port of ``nerfool_tpu/train/trainer.py``): one step
selects a random ray subset of the target view, optionally perturbs the
source views by an inner sign-PGD loop (adversarial training), extracts the
features, renders the subset with stochastic sampling, sums the masked-MSE
criterion of both levels (plus the depth-variance regularizer) and takes one
Adam step with a learning rate per parameter group on a staircase decay.

All of a step's random draws are made in one place (``draw_train_step``):
the ray indices, the adversarial ``delta``'s start, and each inner
iteration's and the outer render's sampling and noise draws, from one
``torch.Generator``, or handed in by the caller. The inner loop renders
without ``geo_noise`` and its loss has no depth-variance term (both apply
to the outer step only, as in the reference); the perturbation is detached
before the outer step. GNT's ``single_net`` renders both levels with
``net_coarse``. The models' parameters are updated in place.

With a ``RaySplit`` over a process group (``--distributed``, one process per
card) each rank takes the step on its own view and draws, and the
parameters' gradients are averaged over the ranks by one all-reduce before
Adam, as the reference's DDP does; rank 0 alone writes checkpoints.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time

import numpy as np
import torch

from nerfool_tpu_torch.attack import losses as L
from nerfool_tpu_torch.attack.attack import (AttackConfig, _frozen,
                                             select_ray_indices)
from nerfool_tpu_torch.attack.perturb import clamp
from nerfool_tpu_torch.parallel.distributed import is_main_process
from nerfool_tpu_torch.render.render_rays import (RenderConfig,
                                                  noise_draws, render_rays,
                                                  sample_draws)
from nerfool_tpu_torch.utils.cameras import get_rays, get_rays_at


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    h: int
    w: int
    n_rand: int = 512
    sample_mode: str = "uniform"  # 'uniform' | 'center'
    center_ratio: float = 0.8
    lrate_feature: float = 1e-3
    lrate_mlp: float = 5e-4  # the aggregators' rate (aggregator_lr)
    lrate_decay_factor: float = 0.5
    lrate_decay_steps: int = 50000
    depth_var_loss: float = 0.0
    # adversarial training: an inner sign-PGD on the source pixels
    use_adv_train: bool = False
    adv_iters: int = 3
    epsilon: float = 8.0  # /255 units, as adv_lr
    adv_lr: float = 2.0


def aggregator_lr(args):
    """The aggregators' learning rate: ``--lrate_gnt`` for GNT,
    ``--lrate_mlp`` for IBRNet, as in the reference's two stacks."""
    return args.lrate_gnt if args.backbone == "gnt" else args.lrate_mlp


def train_config_from_args(args, h, w, n_src) -> TrainConfig:
    """The flags' ``TrainConfig`` for ``h`` x ``w`` views with ``n_src``
    source views: ``N_rand`` scaled by the source-view count, as the
    reference does."""
    return TrainConfig(
        h=h, w=w,
        n_rand=int(1.0 * args.N_rand * args.num_source_views / max(n_src, 1)),
        sample_mode=args.sample_mode, center_ratio=args.center_ratio,
        lrate_feature=args.lrate_feature, lrate_mlp=aggregator_lr(args),
        lrate_decay_factor=args.lrate_decay_factor,
        lrate_decay_steps=args.lrate_decay_steps,
        depth_var_loss=args.depth_var_loss,
        use_adv_train=args.use_adv_train, adv_iters=args.adv_iters,
        epsilon=float(args.epsilon), adv_lr=args.adv_lr)


def select_rays(generator, cfg: TrainConfig, device="cpu"):
    """``n_rand`` distinct pixels of the frame ('uniform') or of its
    central ``center_ratio`` box ('center'), drawn from ``generator``.

    :return: [n_rand] int64 row-major pixel indices
    """
    return select_ray_indices(
        generator, AttackConfig(h=cfg.h, w=cfg.w, n_rand=cfg.n_rand,
                                sample_mode=cfg.sample_mode,
                                center_ratio=cfg.center_ratio), device)


def make_optimizer(cfg: TrainConfig, bundle):
    """Adam over two parameter groups, the feature net at ``lrate_feature``
    and the aggregators at ``lrate_mlp``, each on the staircase decay of
    ``optax.exponential_decay(..., staircase=True)``: the update at count t
    (from 0) uses ``base * factor ** (t // decay_steps)``.

    :return: (optimizer, scheduler); step the scheduler after each update
    """
    agg = [p for m in (bundle.net_coarse, bundle.net_fine) if m is not None
           for p in m.parameters()]
    optimizer = torch.optim.Adam(
        [{"params": list(bundle.feature_net.parameters()),
          "lr": cfg.lrate_feature},
         {"params": agg, "lr": cfg.lrate_mlp}])
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda t: cfg.lrate_decay_factor ** (
            t // cfg.lrate_decay_steps))
    return optimizer, scheduler


def render_draws(generator, render_cfg: RenderConfig, n_rays, device,
                 dtype=torch.float32):
    """One render's random draws: {'samples': (coarse jitter [R, S], fine
    quantiles [R, I] or None) when sampling stochastically, pixelNeRF's
    four draws (``sample_draws``: its sampler draws at every render), else
    None; 'noise': IBRNet's ``geo_noise`` draws (coarse [R, S], fine [R, S
    + I] or None), else None}."""
    s, i = render_cfg.n_samples, render_cfg.n_importance
    rand = lambda *shape: torch.rand(shape, generator=generator,
                                     device=device, dtype=dtype)
    samples = None
    if render_cfg.backbone == "pixelnerf":
        samples = sample_draws(generator, render_cfg, n_rays, dtype, device)
    elif not render_cfg.det:
        samples = (rand(n_rays, s), rand(n_rays, i) if i else None)
    return {"samples": samples, "noise": noise_draws(
        generator, render_cfg, n_rays, dtype, device)}


def make_train_step(bundle, render_cfg: RenderConfig, cfg: TrainConfig,
                    split=None):
    """Build the train step for ``bundle``. ``split``: a
    ``parallel.mesh.RaySplit`` whose ranks average their gradients before
    each update (None: one process).

    step(batch, generator=None, draws=None) -> aux
      batch: {'camera' [34], 'rgb' [H*W, 3], 'depth_range' [1, 2],
              'src_rgbs' [V, Hs, Ws, 3], 'src_cameras' [V, 34]}
      draws: ``step.draw``'s dict, drawn from ``generator`` when None
      aux: {'loss', 'psnr'} detached, and with adversarial training
           'delta', the inner loop's final perturbation

    The step also exposes ``draw(generator, batch)``, ``render_loss``,
    ``adv_perturb_sources`` and ``loss_and_grads(batch, draws) -> (aux,
    grads)`` (the gradients of ``step.params``, before the update), for
    tests and for comparing routes.

    :return: (step, optimizer, scheduler)
    """
    nets = bundle.nets  # the fine net falls back to the coarse one
    modules = (bundle.feature_net, bundle.net_coarse, bundle.net_fine)
    optimizer, scheduler = make_optimizer(cfg, bundle)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    # training renders random pixels per tap and the attacked features
    # alone; the inner render takes no geo_noise
    render_cfg = dataclasses.replace(render_cfg, bspg_specs=None,
                                     use_clean_color=False,
                                     use_clean_density=False)
    inner_cfg = dataclasses.replace(render_cfg, geo_noise=0.0)

    def draw(generator, batch):
        """All of a step's random draws: {'sel', 'outer'} and with
        adversarial training 'delta0' (uniform in the eps-ball, before the
        image-box clamp) and 'inner' (one render's draws per iteration)."""
        src = batch["src_rgbs"]
        dev, dt = src.device, src.dtype
        out = {"sel": select_rays(generator, cfg, dev)}
        if cfg.use_adv_train:
            u = torch.rand(src.shape, generator=generator, device=dev,
                           dtype=dt)
            out["delta0"] = (2.0 * u - 1.0) * (cfg.epsilon / 255.0)
            out["inner"] = [render_draws(generator, inner_cfg, cfg.n_rand,
                                         dev, dt)
                            for _ in range(cfg.adv_iters)]
        out["outer"] = render_draws(generator, render_cfg, cfg.n_rand, dev,
                                    dt)
        return out

    def render_loss(src_rgbs_input, batch, sel, rdraws, inner=False):
        """(loss, psnr) of one render of the rays ``sel`` from features of
        ``src_rgbs_input`` (the RGB taps stay on the clean sources)."""
        rcfg = inner_cfg if inner else render_cfg
        feats = bundle.extract_features(src_rgbs_input)
        cam = batch["camera"].reshape(-1)[:34]
        rays_o, rays_d = get_rays_at(sel, cfg.w, cam[2:18].reshape(4, 4),
                                     cam[18:34].reshape(4, 4))
        rb = {"ray_o": rays_o, "ray_d": rays_d,
              "depth_range": batch["depth_range"], "camera": cam[None]}
        ret = render_rays(nets, rb, feats, rcfg, batch["src_rgbs"],
                          batch["src_cameras"], noise=rdraws["noise"],
                          samples=rdraws["samples"])
        gt = batch["rgb"][sel]
        loss = L.rgb_criterion(ret["outputs_coarse"], gt)
        if ret["outputs_fine"] is not None:
            loss = loss + L.rgb_criterion(ret["outputs_fine"], gt)
        if not inner and cfg.depth_var_loss > 0:
            dv = L.depth_var_loss(ret["outputs_coarse"])
            if ret["outputs_fine"] is not None:
                dv = dv + L.depth_var_loss(ret["outputs_fine"])
            loss = loss + cfg.depth_var_loss * dv
        psnr = -10.0 * torch.log(loss + 1e-6) / math.log(10.0)
        return loss, psnr

    def adv_perturb_sources(batch, sel, draws):
        """The inner sign-PGD that maximizes the render loss over the
        source pixels, from ``draws['delta0']`` clamped into the image box;
        each step projects into the eps-ball, then the box. The weights are
        frozen meanwhile (no weight gradients are formed)."""
        eps, alpha = cfg.epsilon / 255.0, cfg.adv_lr / 255.0
        src = batch["src_rgbs"]
        delta = clamp(draws["delta0"].to(src), -src, 1.0 - src)
        with _frozen(modules), torch.enable_grad():
            for i in range(cfg.adv_iters):
                d = delta.detach().requires_grad_(True)
                loss, _ = render_loss(src + d, batch, sel, draws["inner"][i],
                                      inner=True)
                g, = torch.autograd.grad(loss, d)
                delta = clamp(d.detach() + alpha * torch.sign(g), -eps, eps)
                delta = clamp(delta, -src, 1.0 - src)
        return delta

    def loss_and_grads(batch, draws):
        """(aux, gradients of ``params``): zeros for a parameter the loss
        does not reach, None for one that does not require grad."""
        src = batch["src_rgbs"]
        aux = {}
        if cfg.use_adv_train:
            delta = adv_perturb_sources(batch, draws["sel"], draws)
            src = src + delta.detach()
            aux["delta"] = delta.detach()
        live = [p for p in params if p.requires_grad]
        with torch.enable_grad():
            loss, psnr = render_loss(src, batch, draws["sel"], draws["outer"])
            grads = iter(torch.autograd.grad(loss, live, allow_unused=True))
        out = []
        for p in params:
            g = next(grads) if p.requires_grad else None
            out.append(torch.zeros_like(p) if g is None and p.requires_grad
                       else g)
        aux.update(loss=loss.detach(), psnr=psnr.detach())
        return aux, out

    def step(batch, generator=None, draws=None):
        if draws is None:
            draws = draw(generator, batch)
        aux, grads = loss_and_grads(batch, draws)
        if split is not None:  # DDP: the ranks' mean gradient
            live = [i for i, g in enumerate(grads) if g is not None]
            for i, g in zip(live, split.all_reduce([grads[i] for i in live])):
                grads[i] = g / split.world
        for p, g in zip(params, grads):
            p.grad = g
        optimizer.step()
        scheduler.step()
        optimizer.zero_grad(set_to_none=True)
        return aux

    step.draw = draw
    step.render_loss = render_loss
    step.adv_perturb_sources = adv_perturb_sources
    step.loss_and_grads = loss_and_grads
    step.params = params
    return step, optimizer, scheduler


def make_batch(data, device, dtype=torch.float32):
    """A loader sample (numpy) as the step's batch on ``device``."""
    t = lambda k: torch.as_tensor(np.asarray(data[k]), dtype=dtype,
                                  device=device)
    return {"camera": t("camera").reshape(-1)[:34],
            "rgb": t("rgb").reshape(-1, 3),
            "depth_range": t("depth_range").reshape(1, 2),
            "src_rgbs": t("src_rgbs"),
            "src_cameras": t("src_cameras").reshape(-1, 34)}


@dataclasses.dataclass
class Trainer:
    """The host side of training: view streaming, logging, checkpoints."""

    bundle: object
    render_cfg: RenderConfig
    cfg: TrainConfig
    out_dir: str = "out/exp"
    start_step: int = 0
    chunk_size: int = 4096  # rays per render call of log_view's frames
    split: object = None  # parallel.mesh.RaySplit of a process group

    def __post_init__(self):
        self.step_fn, self.optimizer, self.scheduler = make_train_step(
            self.bundle, self.render_cfg, self.cfg, split=self.split)
        if self.split is not None:  # every rank starts from rank 0's weights
            self.split.broadcast(self.step_fn.params)
        self.device = self.bundle.device
        # one record per printed step: step, loss, psnr, host clock
        self.history = []
        self.last_aux = None
        self.last_batch = None

    def _modules(self):
        b = self.bundle
        return {name: m for name, m in (("feature_net", b.feature_net),
                                        ("net_coarse", b.net_coarse),
                                        ("net_fine", b.net_fine))
                if m is not None}

    def save(self, step):
        """``<out_dir>/model_%06d.pth`` in the reference's layout: the
        modules' state dicts, the optimizer's and the scheduler's, and the
        step. ``models/bundle.create_model(ckpt_path=...)`` loads it."""
        os.makedirs(self.out_dir, exist_ok=True)
        path = os.path.join(self.out_dir, f"model_{step:06d}.pth")
        blob = {name: m.state_dict() for name, m in self._modules().items()}
        blob.update(optimizer=self.optimizer.state_dict(),
                    scheduler=self.scheduler.state_dict(), step=int(step))
        torch.save(blob, path)
        return path

    def load_latest(self, load_opt=True):
        """Resume from the newest ``model_%06d.pth`` in ``out_dir``: the
        weights, and with ``load_opt`` the optimizer and the scheduler.

        :return: the step it was saved at (0 when there is none)
        """
        if not os.path.isdir(self.out_dir):
            return 0
        ckpts = sorted(f for f in os.listdir(self.out_dir)
                       if f.startswith("model_") and f.endswith(".pth"))
        if not ckpts:
            return 0
        blob = torch.load(os.path.join(self.out_dir, ckpts[-1]),
                          map_location=self.device, weights_only=True)
        for name, m in self._modules().items():
            m.load_state_dict(blob[name])
        if load_opt:
            self.optimizer.load_state_dict(blob["optimizer"])
            self.scheduler.load_state_dict(blob["scheduler"])
        self.start_step = int(blob["step"])
        return self.start_step

    def log_view(self, data, step, logger, prefix="val"):
        """Render one whole view (deterministic sampling, no noise) and
        write the panels gt_rgb, pred_{coarse,fine} and depth_{coarse,fine}
        (the reference's log_view_to_tb)."""
        from nerfool_tpu_torch.render.render_image import render_single_image
        from nerfool_tpu_torch.utils.vis import colorize_np

        t = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                      device=self.device)
        cam = t(np.asarray(data["camera"]).reshape(-1)[:34])
        h, w = int(cam[0]), int(cam[1])
        rays_o, rays_d = get_rays(h, w, cam[2:18].reshape(4, 4),
                                  cam[18:34].reshape(4, 4))
        batch = {"ray_o": rays_o, "ray_d": rays_d,
                 "depth_range": t(data["depth_range"]).reshape(1, 2),
                 "camera": cam[None]}
        src_rgbs = t(data["src_rgbs"])
        src_cams = t(data["src_cameras"]).reshape(-1, 34)
        vcfg = dataclasses.replace(self.render_cfg, det=True, geo_noise=0.0,
                                   bspg_specs=None)
        with torch.no_grad():
            feats = self.bundle.extract_features(src_rgbs)
            out = render_single_image(self.bundle.nets, batch, feats, vcfg,
                                      h, w, src_rgbs, src_cams,
                                      chunk_size=self.chunk_size)
        if data.get("rgb") is not None:
            logger.add_image(f"{prefix}/gt_rgb",
                             np.asarray(data["rgb"]).reshape(h, w, 3), step)
        for lvl in ("outputs_coarse", "outputs_fine"):
            if out[lvl] is None:
                continue
            tag = lvl.split("_")[1]
            logger.add_image(f"{prefix}/pred_{tag}",
                             out[lvl]["rgb"].float().cpu().numpy(), step)
            if out[lvl].get("depth") is not None:
                logger.add_image(f"{prefix}/depth_{tag}", colorize_np(
                    out[lvl]["depth"].float().cpu().numpy()), step)

    def train(self, data_iter, n_iters, generator=None, i_print=100,
              i_weights=10000, log_fn=print, i_img=0, val_iter=None,
              logger=None):
        """``n_iters`` steps from ``start_step`` on views of ``data_iter``,
        every draw from ``generator`` (seeded 0 when None): a line and a
        ``history`` record every ``i_print`` steps, a checkpoint every
        ``i_weights`` (rank 0 of a group alone), ``log_view`` panels every
        ``i_img`` (0: none)."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        t0 = time.perf_counter()
        for i in range(self.start_step, self.start_step + n_iters):
            batch = make_batch(next(data_iter), self.device)
            aux = self.step_fn(batch, generator=generator)
            self.last_aux, self.last_batch = aux, batch
            if (i + 1) % i_print == 0:
                loss, psnr = float(aux["loss"]), float(aux["psnr"])
                now = time.perf_counter()
                dt = (now - t0) / (i + 1 - self.start_step)
                log_fn(f"step {i+1}: loss={loss:.5f} psnr={psnr:.2f} "
                       f"({dt*1e3:.0f} ms/it)")
                self.history.append({"step": i + 1, "loss": loss,
                                     "psnr": psnr, "time": now})
            if (i + 1) % i_weights == 0 and is_main_process():
                self.save(i + 1)
            if i_img and logger is not None and val_iter is not None and (
                    (i + 1) % i_img == 0):
                self.log_view(next(val_iter), i + 1, logger)
        return self.history
