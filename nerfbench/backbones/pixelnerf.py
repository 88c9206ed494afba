"""pixelNeRF (Yu et al., CVPR 2021): a ResNet-34 encoder's 512-channel
latent map indexed at every sample's pixel in every source view, a
per-view residual MLP averaged over the views after three blocks, and a
sampler that draws at every call (``nerfbench/reference/pixelnerf.py``).

Its draws come from the benchmark's stream (``draw_shapes``; the
``attack_drawn`` kind hands the same draws to the program's step and, as
``model['draws']``, an iterator of one tuple a render, to the reference)."""
from __future__ import annotations

from nerfbench.counts import pixelnerf as counts
from nerfbench.reference import pixelnerf as ref


def d_hidden(flags):
    """``ResnetFC``'s hidden width (its other widths are the reference's
    constants, ``default_mv.conf``'s)."""
    return int(flags.get("pixelnerf_d_hidden", 512))


def modules(flags):
    return {"feature_net": ref.Encoder(),
            "net_coarse": ref.ResnetFC(d_hidden(flags)),
            "net_fine": ref.ResnetFC(d_hidden(flags))}


def model(flags, mods):
    return {"n_samples": int(flags["N_samples"]),
            "net_coarse": mods["net_coarse"], "net_fine": mods["net_fine"]}


def draw_shapes(flags, n_rays):
    """The sampler's draws for ``n_rays`` rays, in the order the program's
    ``sample_draws`` takes them: (shape, 'uniform' or 'normal')."""
    s, i = int(flags["N_samples"]), int(flags["N_importance"])
    d = int(flags.get("pixelnerf_n_depth", 16))
    return [((n_rays, s), "uniform"), ((n_rays, i), "uniform"),
            ((n_rays, i), "uniform"), ((n_rays, d), "normal")]


def render_rays(model, rays_o, rays_d, camera, depth_range, feats, src_rgbs,
                src_cameras, given=None):
    """Both levels, at the draws of ``given['draws']``, else the next of
    ``model['draws']`` (the ``attack_drawn`` kind's, one a step)."""
    if given is not None and "draws" in given:
        draws = given["draws"]
    elif "draws" in model:
        draws = next(model["draws"])
    else:
        raise ValueError("pixelNeRF's reference samples at the draws it is "
                         "handed: none given")
    return ref.render(model, rays_o, rays_d, depth_range, feats[0],
                      src_cameras.detach(), draws)


def frame_rgb(coarse):
    return coarse["rgb"]


def feature_flops(flags, n_views, h, w):
    return counts.encoder_flops(n_views, h, w)


def points_per_ray(flags):
    """(coarse, fine) samples a ray."""
    s, i = int(flags["N_samples"]), int(flags["N_importance"])
    return s, s + i + int(flags.get("pixelnerf_n_depth", 16))


def _mlp_widths(flags):
    return {"d_in": ref.D_IN, "n_blocks": ref.N_BLOCKS,
            "d_hidden": d_hidden(flags), "combine_layer": ref.COMBINE_LAYER,
            "d_latent": ref.D_LATENT, "d_out": ref.D_OUT}


def aggregator_flops(flags, n_views, rays, backward):
    fwd = rays * counts.mlp_flops(n_views, sum(points_per_ray(flags)),
                                  **_mlp_widths(flags))
    return 2 * fwd if backward else fwd


def aggregator_least_seconds(flags, n_views, rays):
    """The least time of ``ResnetFC``'s forward over ``rays`` rays (both
    levels, every source view; ``counts/pixelnerf.py``)."""
    return counts.mlp_least_seconds(n_views, rays * sum(points_per_ray(flags)),
                                    **_mlp_widths(flags))


def tiny(flags):
    return {"N_samples": 8, "N_importance": 4, "pixelnerf_n_depth": 4,
            "pixelnerf_d_hidden": 32, "N_rand": 32, "chunk_size": 256}
