"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py).

Scenes are made with numpy from a seed and handed to both packages as the
same arrays. A camera is built once by the JAX package and its matrices
are handed to the port as they are, so both rasterizers see bit-identical
cameras (the builders themselves are compared in test_torch_core.py).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from humangaussian_torch.core.camera import Camera
from port_parity_torch import tiny_prompt_arrays
from humangaussian_tpu.core.camera import camera_from_c2w, look_at_c2w


def make_scene(n=300, n_dead=50, seed=0, sh_degree=0):
    """numpy (means, log_scales, quats, features, opacity_logits, alive),
    the scene of tests/test_rasterize_tiled.py::make_scene."""
    rng = np.random.RandomState(seed)
    k = (sh_degree + 1) ** 2
    means = rng.randn(n, 3).astype(np.float32) * 0.5
    log_scales = (rng.randn(n, 3) * 0.5 - 3.0).astype(np.float32)
    quats = rng.randn(n, 4).astype(np.float32)
    feats = (rng.randn(n, k, 3) * 0.3).astype(np.float32)
    opa_logits = rng.randn(n).astype(np.float32)
    alive = np.ones(n, bool)
    if n_dead:
        alive[-n_dead:] = False
    return means, log_scales, quats, feats, opa_logits, alive


def activated(scene):
    """(means, scales, quats, features, opacities, alive) in numpy."""
    means, log_scales, quats, feats, opa_logits, alive = scene
    return (means, np.exp(log_scales), quats, feats,
            1.0 / (1.0 + np.exp(-opa_logits.astype(np.float64))).astype(
                np.float32), alive)


def jax_args(scene):
    return tuple(jnp.asarray(x) for x in activated(scene))


def torch_args(scene):
    return tuple(torch.from_numpy(np.ascontiguousarray(x))
                 for x in activated(scene))


def jax_camera(h=64, w=64, eye=(0.3, 0.2, 3.0), fovy=0.8):
    c2w = look_at_c2w(jnp.array(eye, jnp.float32), jnp.zeros(3),
                      jnp.array([0.0, 1.0, 0.0]))
    return camera_from_c2w(c2w, fovy, h, w)


def torch_camera_from_jax(cam) -> Camera:
    """The port's Camera holding the JAX camera's arrays (any batch dims)."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    return Camera(view=t(cam.view), full_proj=t(cam.full_proj),
                  campos=t(cam.campos), tan_fovx=t(cam.tan_fovx),
                  tan_fovy=t(cam.tan_fovy), height=cam.height,
                  width=cam.width)


def stack_jax_cameras(cams):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *cams)


def adam_leaves(adam) -> dict:
    """A JAX AdamState as numpy leaves (convert.adam_state_from_numpy)."""
    return {"mu": {k: np.asarray(v) for k, v in adam.mu.items()},
            "nu": {k: np.asarray(v) for k, v in adam.nu.items()},
            "count": int(adam.count)}


def densify_leaves(ds) -> dict:
    """A JAX DensifyState as numpy leaves."""
    return {k: np.asarray(v) for k, v in ds._asdict().items()}


def scene_leaves(scene) -> dict:
    """A JAX GaussianScene as numpy leaves."""
    return {k: np.asarray(v) for k, v in scene._asdict().items()}


def photo_state_leaves(state) -> dict:
    """A JAX PhotoTrainState as numpy leaves (the PRNG key is left out;
    convert.photo_state_from_numpy seeds a torch.Generator instead)."""
    return {"scene": scene_leaves(state.scene),
            "adam": adam_leaves(state.adam),
            "densify": densify_leaves(state.densify),
            "step": int(state.step),
            "active_sh_degree": int(state.active_sh_degree)}


def assert_tree_close(got: dict, want: dict, rtol=0.0, atol=0.0,
                      scale_rel=None, what=""):
    """Every entry of `got` (torch) against `want` (JAX / numpy). With
    `scale_rel`, the tolerance is that fraction of the entry's max-|want|
    (plus `atol`)."""
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        w = np.asarray(want[k])
        tol = atol
        if scale_rel is not None:
            tol = atol + scale_rel * float(np.max(np.abs(w))) if w.size else atol
        np.testing.assert_allclose(np_(got[k]), w, rtol=rtol, atol=tol,
                                   err_msg=f"{what} {k}")


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# ---- the guidance slice --------------------------------------------------


def flax_leaves(tree) -> dict:
    """A Flax parameter tree as nested plain dicts of numpy arrays (what
    humangaussian_torch.convert.*_state_dict_from_flax take)."""
    return {k: flax_leaves(v) if hasattr(v, "items") else np.asarray(v)
            for k, v in tree.items()}


def _jitter(leaves: dict, rs, amount=0.05) -> dict:
    """Move every bias and norm scale off its initial 0 / 1, so that a
    parity test exercises them."""
    out = {}
    for k, v in leaves.items():
        if hasattr(v, "items"):
            out[k] = _jitter(v, rs, amount)
        elif v.ndim == 1:
            out[k] = (v + amount * rs.randn(*v.shape)).astype(np.float32)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def tiny_unet_pair(seed=0, flash=False, latent=8):
    """(flax module, flax params, port module) of the tiny dual-branch UNet
    with the same weights: Flax initializes from the seed, biases and norm
    scales are jittered with numpy, and the port loads the tree through
    `unet_state_dict_from_flax`. Cached: callers share the modules and must
    not change their weights."""
    import dataclasses

    from humangaussian_torch.convert import unet_state_dict_from_flax
    from humangaussian_torch.guidance import unet as port_unet
    from humangaussian_tpu.guidance import unet as jax_unet

    jcfg = dataclasses.replace(jax_unet.TINY_TEST_CONFIG,
                               flash_attention=flash)
    module = jax_unet.DualBranchUNet(jcfg)
    x = jnp.zeros((1, latent, latent, 8))
    params = module.init(jax.random.PRNGKey(seed), x, x, jnp.zeros((1,)),
                         jnp.zeros((1, 7, jcfg.cross_attention_dim)),
                         jnp.zeros((1, 6)))
    leaves = _jitter(flax_leaves(params), np.random.RandomState(seed + 1))
    port = port_unet.DualBranchUNet(dataclasses.replace(
        port_unet.TINY_TEST_CONFIG, flash_attention=flash))
    port.load_state_dict(unet_state_dict_from_flax(leaves))
    return module, jax.tree.map(jnp.asarray, leaves), port.eval()


@functools.lru_cache(maxsize=None)
def tiny_single_unet_pair(seed=0, kind="sd", encoder_hid_dim=None):
    """(flax module, flax params, port module) of a tiny `SingleUNet` with
    the same weights, as `tiny_unet_pair`: `kind` "sd" is
    TINY_SINGLE_CONFIG (4 channels in and out; `encoder_hid_dim` adds the
    text projection), "if" TINY_IF_CONFIG (3 in, 6 out, a 48-wide T5
    stand-in projected to 32)."""
    import dataclasses

    from humangaussian_torch.convert import unet_state_dict_from_flax
    from humangaussian_torch.guidance import deep_floyd as port_df
    from humangaussian_torch.guidance import unet as port_unet
    from humangaussian_tpu.guidance import deep_floyd as jax_df
    from humangaussian_tpu.guidance import unet as jax_unet

    if kind == "if":
        jcfg, pcfg = jax_df.TINY_IF_CONFIG, port_df.TINY_IF_CONFIG
    else:
        jcfg = dataclasses.replace(jax_unet.TINY_SINGLE_CONFIG,
                                   encoder_hid_dim=encoder_hid_dim)
        pcfg = dataclasses.replace(port_unet.TINY_SINGLE_CONFIG,
                                   encoder_hid_dim=encoder_hid_dim)
    module = jax_unet.SingleUNet(jcfg)
    ctx = jcfg.encoder_hid_dim or jcfg.cross_attention_dim
    params = module.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8, 8, jcfg.in_channels)),
        jnp.zeros((1,)), jnp.zeros((1, 7, ctx)))
    leaves = _jitter(flax_leaves(params), np.random.RandomState(seed + 1))
    port = port_unet.SingleUNet(pcfg)
    port.load_state_dict(unet_state_dict_from_flax(leaves))
    return module, jax.tree.map(jnp.asarray, leaves), port.eval()


@functools.lru_cache(maxsize=None)
def tiny_vae_pair(seed=0):
    """(flax module, flax params, port module) of the tiny VAE, as
    `tiny_unet_pair`."""
    from humangaussian_torch.convert import vae_state_dict_from_flax
    from humangaussian_torch.guidance import vae as port_vae
    from humangaussian_tpu.guidance import vae as jax_vae

    module = jax_vae.AutoencoderKL(jax_vae.tiny_vae_config())
    key = jax.random.PRNGKey(seed)
    params = module.init(key, jnp.zeros((1, 16, 16, 3)), key)
    leaves = _jitter(flax_leaves(params), np.random.RandomState(seed + 2))
    port = port_vae.AutoencoderKL(port_vae.tiny_vae_config())
    port.load_state_dict(vae_state_dict_from_flax(leaves))
    return module, jax.tree.map(jnp.asarray, leaves), port.eval()


def tiny_guidance_pair(seed=0, **guidance_cfg):
    """(JAX DualBranchGuidance, port DualBranchGuidance) at the tiny widths
    (16^2 images, 8^2 latents) sharing weights, schedule and config."""
    from humangaussian_torch.guidance import dual_branch as port_db
    from humangaussian_torch.guidance.schedule import (
        DiffusionSchedule as PortSchedule,
    )
    from humangaussian_tpu.guidance import dual_branch as jax_db
    from humangaussian_tpu.guidance.schedule import DiffusionSchedule

    cfg = dict(latent_size=8, image_size=16, guidance_scale=7.5,
               remat_encode=False)
    cfg.update(guidance_cfg)
    junet, juparams, punet = tiny_unet_pair(seed)
    jvae, jvparams, pvae = tiny_vae_pair(seed)
    jg = jax_db.DualBranchGuidance(
        unet=junet, unet_params=juparams, vae=jvae, vae_params=jvparams,
        schedule=DiffusionSchedule.create(),
        cfg=jax_db.GuidanceConfig(**cfg))
    pg = port_db.DualBranchGuidance(
        punet, pvae, PortSchedule.create(device="cpu"),
        port_db.GuidanceConfig(**cfg))
    return jg, pg


def jax_guidance_draws(jg, rng, b, latent=8):
    """The normal draws `DualBranchGuidance.__call__` of the JAX package
    makes from `rng` (its key splits, per-sample folding included), as
    numpy [b, latent, latent, 4] arrays keyed rgb, depth, pose, noise,
    dnoise: what the port takes as `latent_eps`, `noise`, `depth_noise`."""
    from humangaussian_tpu.guidance.dual_branch import per_sample_normal

    idx = jnp.arange(b, dtype=jnp.int32)
    k_rgb, k_depth, k_pose, k_grad = jax.random.split(rng, 4)
    k_noise, k_dnoise = jax.random.split(k_grad)
    shape = (b, latent, latent, 4)
    return {name: np.array(per_sample_normal(k, idx, shape), np.float32)
            for name, k in (("rgb", k_rgb), ("depth", k_depth),
                            ("pose", k_pose), ("noise", k_noise),
                            ("dnoise", k_dnoise))}


# ---- the avatar trainer --------------------------------------------------


def jax_camera_draws(key, b) -> dict:
    """The unit draws `humangaussian_tpu.data.cameras.sample_camera_batch`
    makes from `key` (its 12 split keys), named as
    `humangaussian_torch.data.cameras.camera_draws` returns them, as CPU
    tensors: JAX's uniform(minval, maxval) scales the same unit draw."""
    keys = jax.random.split(key, 12)

    def u(i, shape):
        return np.array(jax.random.uniform(keys[i], shape), np.float32)

    def n(i, shape):
        return np.array(jax.random.normal(keys[i], shape), np.float32)

    draws = dict(choice=u(0, (4,)), elevation_uniform=u(1, (b,)),
                 elevation_sphere=u(2, (b,)), azimuth=u(3, (b,)),
                 distance=u(4, (b,)), camera_perturb=u(5, (b, 3)),
                 center_perturb=n(6, (b, 3)), up_perturb=n(7, (b, 3)),
                 fovy=u(8, (b,)), light_distance=u(9, (b,)),
                 light_dir=n(10, (b, 3)))
    return {k: torch.from_numpy(v) for k, v in draws.items()}


def tiny_system_pair(seed=0, capacity=2048, batch=2, tile_capacity=256,
                     max_tiles=16, guidance_pair=None, prompt_dim=32, **cfg):
    """(JAX GaussianDreamerSystem, port GaussianDreamerSystem) at the sizes
    of `humangaussian_tpu.testing.tiny_system` (64^2 renders, capacity
    2048, 500 points, batch 2, the tiny prior) built from one seed: the
    prior through `tiny_guidance_pair` (or the (JAX, port) `guidance_pair`
    given), the prompt embeddings from numpy (`prompt_dim` wide), each
    package's skeleton from its own toy SMPL-X model."""
    from humangaussian_torch.convert import prompt_embeddings_from_numpy
    from humangaussian_torch.data.cameras import (
        RandomCameraConfig as PortCameraConfig,
    )
    from humangaussian_torch.ops.projection import (
        RasterizeConfig as PortRasterizeConfig,
    )
    from humangaussian_torch.smplx.model import toy_model as port_toy_model
    from humangaussian_torch.smplx.skeleton import Skeleton as PortSkeleton
    from humangaussian_torch.train import system as port_system
    from humangaussian_tpu.data.cameras import RandomCameraConfig
    from humangaussian_tpu.guidance.prompt import PromptEmbeddings
    from humangaussian_tpu.ops.projection import RasterizeConfig
    from humangaussian_tpu.smplx.model import toy_model
    from humangaussian_tpu.smplx.skeleton import Skeleton
    from humangaussian_tpu.train import system as jax_system

    jg, pg = guidance_pair or tiny_guidance_pair(seed, remat_encode=True)
    sys_cfg = dict(
        capacity=capacity, pts_num=500, pose_image_size=64,
        tile_capacity=tile_capacity, densify_prune_start_step=2,
        densify_prune_interval=3, densify_prune_end_step=100,
        prune_only_start_step=100, prune_only_end_step=200,
        prune_only_interval=3)
    sys_cfg.update(cfg)
    cam_cfg = dict(batch_size=batch, height=64, width=64, eval_height=64,
                   eval_width=64, n_val_views=2, n_test_views=3)
    prompts = tiny_prompt_arrays(seed, d=prompt_dim)
    js = jax_system.GaussianDreamerSystem(
        jax_system.GaussianDreamerConfig(**sys_cfg),
        Skeleton(style="humansd", apose=True).load_smplx(
            toy_model()).scale(-10),
        jg, PromptEmbeddings(**{k: jnp.asarray(v)
                                for k, v in prompts.items()}),
        camera_cfg=RandomCameraConfig(**cam_cfg),
        raster_cfg=RasterizeConfig(tile=32,
                                   max_tiles_per_gaussian=max_tiles))
    ps = port_system.GaussianDreamerSystem(
        port_system.GaussianDreamerConfig(**sys_cfg),
        PortSkeleton(style="humansd", apose=True).load_smplx(
            port_toy_model()).scale(-10),
        pg, prompt_embeddings_from_numpy(prompts, device="cpu"),
        camera_cfg=PortCameraConfig(**cam_cfg),
        raster_cfg=PortRasterizeConfig(tile=32,
                                       max_tiles_per_gaussian=max_tiles),
        device="cpu")
    return js, ps


def dreamer_state_from_jax(state, seed=0, tile_cap=None):
    """The port's TrainState holding a JAX TrainState's leaves (the JAX
    PRNG key has no counterpart: the generator is seeded with `seed`;
    `tile_cap` None renders with the config's `tile_capacity`, as the JAX
    step does without its static `tile_cap`)."""
    from humangaussian_torch.convert import (
        adam_state_from_numpy,
        densify_state_from_numpy,
        scene_from_numpy,
    )
    from humangaussian_torch.train.system import TrainState

    return TrainState(
        scene=scene_from_numpy(scene_leaves(state.scene), "cpu"),
        adam=adam_state_from_numpy(adam_leaves(state.adam), "cpu"),
        densify=densify_state_from_numpy(densify_leaves(state.densify),
                                         "cpu"),
        step=int(state.step),
        generator=torch.Generator().manual_seed(seed),
        tile_cap=tile_cap)


# ---- the NeRF stack ------------------------------------------------------


def nerf_leaves(params, seed=0, table_scale=0.5) -> dict:
    """A Flax NeRF parameter tree as numpy leaves, moved off its init so
    that a parity test exercises every part: biases jittered (`_jitter`),
    a hash `table` redrawn uniform in +-`table_scale` (its init is +-1e-4,
    which hides the encoding's arithmetic)."""
    rs = np.random.RandomState(seed)

    def move(tree):
        out = {}
        for k, v in tree.items():
            if hasattr(v, "items"):
                out[k] = move(v)
            elif k == "table":
                out[k] = rs.uniform(-table_scale, table_scale,
                                    v.shape).astype(np.float32)
            else:
                out[k] = v
        return out

    return _jitter(move(flax_leaves(params)), rs)


def jax_render_draws(key, rays, samples, importance=0) -> tuple:
    """The unit uniforms `NerfVolumeRenderer.render_rays` of the JAX
    package draws from `key`: (jitter [rays, samples], fine_u [rays,
    importance] or None), as CPU tensors."""
    k_coarse, k_fine = jax.random.split(key)
    jitter = torch.from_numpy(np.array(
        jax.random.uniform(k_coarse, (rays, samples)), np.float32))
    fine = None
    if importance:
        fine = torch.from_numpy(np.array(
            jax.random.uniform(k_fine, (rays, importance)), np.float32))
    return jitter, fine


def torch_camera_batch(cams):
    """The port's CameraBatch holding a JAX CameraBatch's arrays."""
    from humangaussian_torch.data.cameras import CameraBatch

    return CameraBatch(*(torch.from_numpy(np.array(x)) for x in cams))
