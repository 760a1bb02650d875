"""The guidance slice as a whole: guidance/dual_branch.py of the port
against the JAX package at the tiny widths (16^2 images, 8^2 latents), weights shared through the
converters, with the JAX side's noise draws (its key splits, reproduced by
`port_parity.jax_guidance_draws`) injected into the port.

Tolerances: `compute_grad`, `compute_grad_sjc`, `grad` and the image
gradients 2e-4 of the reference's max (the tolerance of
tests/test_anpg_grad_parity.py, which holds the JAX package to executing
torch mirrors); losses 2e-4 relative; `sample_joint` and `guidance_eval`
1e-4 absolute on [0, 1] images. A `branch_num = 2` prior takes a list of
structure images.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.guidance import dual_branch as port_db
from humangaussian_tpu.guidance import dual_branch as jax_db
from humangaussian_tpu.ops import groupnorm as jax_gn
from port_parity import jax_guidance_draws, tiny_guidance_pair
from port_parity_torch import tiny_port_guidance

torch.set_num_threads(1)
B, HW, LAT = 2, 16, 8
REL = 2e-4
T = np.array([120, 700], np.int64)  # one on each side of anpg_boundary_t


@pytest.fixture(autouse=True)
def pallas(monkeypatch):
    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)


def _scene(seed=3, hw=HW):
    rng = np.random.RandomState(seed)
    return (rng.rand(B, hw, hw, 3).astype(np.float32),  # pose
            rng.rand(B, hw, hw, 3).astype(np.float32),  # rgb
            rng.rand(B, hw, hw, 3).astype(np.float32),  # depth
            (rng.randn(3 * B, 7, 32) * 0.2).astype(np.float32))


def _close(got, want, what, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("mode", ["anpg", "sds"])
def test_compute_grad_matches(mode):
    jg, pg = tiny_guidance_pair(seed=0, mode=mode)
    rng = np.random.RandomState(5)
    lat, dlat, whole = (rng.randn(B, LAT, LAT, 4).astype(np.float32)
                        for _ in range(3))
    text = _scene()[3]
    key = jax.random.PRNGKey(7)
    k_noise, k_dnoise = jax.random.split(key)
    noise = np.asarray(jax.random.normal(k_noise, lat.shape, jnp.float32))
    dnoise = np.asarray(jax.random.normal(k_dnoise, lat.shape, jnp.float32))
    want = jg.compute_grad(jnp.asarray(lat), jnp.asarray(dlat),
                           jnp.asarray(whole), jnp.asarray(T, jnp.int32),
                           jnp.asarray(text), key)
    got = pg.compute_grad(
        torch.from_numpy(lat), torch.from_numpy(dlat),
        torch.from_numpy(whole), torch.from_numpy(T), torch.from_numpy(text),
        noise=torch.tensor(noise), depth_noise=torch.tensor(dnoise))
    assert got.shape == (B, LAT, LAT, 8) and not got.requires_grad
    _close(got, want, f"compute_grad {mode}")
    # the two timesteps took different branches of the ANPG mask
    assert float(got[0].abs().max()) > 0 and float(got[1].abs().max()) > 0


@pytest.mark.parametrize("mode,remat", [("anpg", False), ("sds", False),
                                        ("anpg", True)])
def test_call_matches(mode, remat):
    """loss_sds, grad_norm, grad and d(loss)/d(rgb, depth) of the public
    step; with `remat_encode` the port recomputes the encodes under
    torch.utils.checkpoint and must give the same gradients."""
    jg, pg = tiny_guidance_pair(seed=0, mode=mode, remat_encode=remat)
    pose, rgb, depth, text = _scene()
    key = jax.random.PRNGKey(11)

    def jcall(rgb_, depth_):
        out = jg(jnp.asarray(pose), rgb_, depth_, jnp.asarray(text),
                 jnp.asarray(T, jnp.int32), key)
        return out["loss_sds"], out

    (jl, jout), (jg_rgb, jg_depth) = jax.value_and_grad(
        jcall, argnums=(0, 1), has_aux=True)(jnp.asarray(rgb),
                                             jnp.asarray(depth))

    eps = {k: torch.from_numpy(v)
           for k, v in jax_guidance_draws(jg, key, B, LAT).items()}
    rgb_t = torch.tensor(rgb, requires_grad=True)
    depth_t = torch.tensor(depth, requires_grad=True)
    out = pg(torch.from_numpy(pose), rgb_t, depth_t, torch.from_numpy(text),
             torch.from_numpy(T), latent_eps=eps, noise=eps["noise"],
             depth_noise=eps["dnoise"])
    out["loss_sds"].backward()

    assert float(out["loss_sds"].detach()) == pytest.approx(float(jl),
                                                            rel=2e-4)
    assert float(out["grad_norm"]) == pytest.approx(
        float(jout["grad_norm"]), rel=2e-4)
    _close(out["grad"], jout["grad"], "grad")
    _close(rgb_t.grad, jg_rgb, "d(loss)/d(rgb)")
    _close(depth_t.grad, jg_depth, "d(loss)/d(depth)")
    assert float(rgb_t.grad.abs().max()) > 0
    assert float(depth_t.grad.abs().max()) > 0


def test_call_resizes_and_clips():
    """32^2 renders are resized to the 16^2 the VAE takes (anti-aliased
    bilinear on both sides), and `grad_clip_val` clamps the gradient."""
    jg, pg = tiny_guidance_pair(seed=0, mode="anpg")
    pose, rgb, depth, text = _scene(seed=4, hw=32)
    key = jax.random.PRNGKey(13)
    clip = 0.05
    jout = jg(jnp.asarray(pose), jnp.asarray(rgb), jnp.asarray(depth),
              jnp.asarray(text), jnp.asarray(T, jnp.int32), key,
              grad_clip_val=clip)
    eps = {k: torch.from_numpy(v)
           for k, v in jax_guidance_draws(jg, key, B, LAT).items()}
    out = pg(torch.from_numpy(pose), torch.from_numpy(rgb),
             torch.from_numpy(depth), torch.from_numpy(text),
             torch.from_numpy(T), grad_clip_val=clip, latent_eps=eps,
             noise=eps["noise"], depth_noise=eps["dnoise"])
    assert float(out["grad"].abs().max()) == pytest.approx(clip)
    assert float((out["grad"].abs() == clip).float().mean()) > 0.01
    # 2e-4 of the unclipped gradient's scale (the per-pixel norm clamp
    # bounds it at 1), not of the clip value
    np.testing.assert_allclose(out["grad"].numpy(), np.asarray(jout["grad"]),
                               atol=REL)
    assert float(out["loss_sds"]) == pytest.approx(float(jout["loss_sds"]),
                                                   rel=2e-4)


def test_sample_joint_matches():
    """Three DDIM steps from injected initial latents."""
    jg, pg = tiny_guidance_pair(seed=0)
    pose, _, _, text = _scene(seed=6)
    text2 = text[: 2 * B]
    key = jax.random.PRNGKey(17)
    k_pose, k_lat, k_dep = jax.random.split(key, 3)
    shape = (B, LAT, LAT, 4)
    draws = [np.array(jax.random.normal(k, shape, jnp.float32))
             for k in (k_pose, k_lat, k_dep)]
    want_img, want_depth = jg.sample_joint(jnp.asarray(pose),
                                           jnp.asarray(text2), key,
                                           num_steps=3)
    img, dep = pg.sample_joint(
        torch.from_numpy(pose), torch.from_numpy(text2), num_steps=3,
        latent_eps=torch.from_numpy(draws[0]),
        latents=torch.from_numpy(draws[1]),
        depth_latents=torch.from_numpy(draws[2]))
    assert img.shape == (B, HW, HW, 3)
    np.testing.assert_allclose(img.numpy(), np.asarray(want_img), atol=1e-4)
    np.testing.assert_allclose(dep.numpy(), np.asarray(want_depth), atol=1e-4)
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0


def test_generator_reproduces_a_step():
    pg = tiny_port_guidance(seed=0)
    pose, rgb, depth, text = map(torch.from_numpy, _scene())
    t = torch.from_numpy(T)
    outs = [pg(pose, rgb, depth, text, t, torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(outs[0]["grad"], outs[1]["grad"])
    other = pg(pose, rgb, depth, text, t, torch.Generator().manual_seed(6))
    assert not torch.equal(outs[0]["grad"], other["grad"])


def test_small_functions_match():
    rng = np.random.RandomState(8)
    a, b = (rng.randn(2, 4, 4, 8).astype(np.float32) for _ in range(2))
    _close(port_db.rescale_noise_cfg(torch.from_numpy(a), torch.from_numpy(b),
                                     0.7),
           jax_db.rescale_noise_cfg(jnp.asarray(a), jnp.asarray(b), 0.7),
           "rescale_noise_cfg", rel=1e-6)
    assert port_db.min_max_steps(1000, 0.02, 0.98) == \
        jax_db.min_max_steps(1000, 0.02, 0.98)
    t = port_db.sample_timesteps(
        4096, 20, 25, torch.Generator().manual_seed(0), device="cpu")
    assert set(t.tolist()) == set(range(20, 26))
    for name in ("RGB_MEAN", "RGB_STD", "WHOLE_MEAN", "WHOLE_STD",
                 "DEPTH_MEAN", "DEPTH_STD", "VAE_SCALE"):
        assert getattr(port_db, name) == getattr(jax_db, name)
    assert dataclasses.asdict(port_db.GuidanceConfig()) == \
        dataclasses.asdict(jax_db.GuidanceConfig())
    with pytest.raises(ValueError):
        tiny_port_guidance(mode="nfsd")


def _grad_inputs(seed=5):
    rng = np.random.RandomState(seed)
    return [rng.randn(B, LAT, LAT, 4).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("var_red", [True, False])
def test_compute_grad_sjc_matches(var_red):
    """Score Jacobian Chaining with the JAX side's per-sample draws
    injected."""
    from humangaussian_tpu.guidance.dual_branch import per_sample_normal

    jg, pg = tiny_guidance_pair(seed=0, mode="sjc")
    lat, dlat, whole = _grad_inputs()
    text = _scene()[3]
    key = jax.random.PRNGKey(9)
    idx = jnp.arange(B, dtype=jnp.int32)
    noise, dnoise = (np.array(per_sample_normal(k, idx, lat.shape))
                     for k in jax.random.split(key))
    want = jg.compute_grad_sjc(jnp.asarray(lat), jnp.asarray(dlat),
                               jnp.asarray(whole), jnp.asarray(T, jnp.int32),
                               jnp.asarray(text), key, var_red=var_red)
    got = pg.compute_grad_sjc(
        torch.from_numpy(lat), torch.from_numpy(dlat),
        torch.from_numpy(whole), torch.from_numpy(T), torch.from_numpy(text),
        noise=torch.from_numpy(noise), depth_noise=torch.from_numpy(dnoise),
        var_red=var_red)
    assert got.shape == (B, LAT, LAT, 8)
    _close(got, want, f"compute_grad_sjc var_red={var_red}")


def test_sjc_call_matches():
    """mode: sjc through the public step: loss, grad and d(loss)/d(rgb)."""
    jg, pg = tiny_guidance_pair(seed=0, mode="sjc")
    pose, rgb, depth, text = _scene(seed=8)
    key = jax.random.PRNGKey(21)

    def jcall(rgb_):
        out = jg(jnp.asarray(pose), rgb_, jnp.asarray(depth),
                 jnp.asarray(text), jnp.asarray(T, jnp.int32), key)
        return out["loss_sds"], out

    (jl, jout), jg_rgb = jax.value_and_grad(jcall, has_aux=True)(
        jnp.asarray(rgb))
    eps = {k: torch.from_numpy(v)
           for k, v in jax_guidance_draws(jg, key, B, LAT).items()}
    rgb_t = torch.tensor(rgb, requires_grad=True)
    out = pg(torch.from_numpy(pose), rgb_t, torch.from_numpy(depth),
             torch.from_numpy(text), torch.from_numpy(T), latent_eps=eps,
             noise=eps["noise"], depth_noise=eps["dnoise"])
    out["loss_sds"].backward()
    assert float(out["loss_sds"].detach()) == pytest.approx(float(jl),
                                                            rel=2e-4)
    _close(out["grad"], jout["grad"], "sjc grad")
    _close(rgb_t.grad, jg_rgb, "sjc d(loss)/d(rgb)")


def test_guidance_eval_matches():
    """The 1-step estimates and a 3-step DDIM rollout from two noise
    levels (each sample stops at its own t_start)."""
    jg, pg = tiny_guidance_pair(seed=0)
    lat, dlat, whole = _grad_inputs(seed=10)
    text2 = _scene(seed=11)[3][: 2 * B]
    t_start = np.array([400, 900], np.int64)
    want = jg.guidance_eval(jnp.asarray(lat), jnp.asarray(dlat),
                            jnp.asarray(whole), jnp.asarray(t_start,
                                                            jnp.int32),
                            jnp.asarray(text2), num_steps=3)
    got = pg.guidance_eval(torch.from_numpy(lat), torch.from_numpy(dlat),
                           torch.from_numpy(whole),
                           torch.from_numpy(t_start),
                           torch.from_numpy(text2), num_steps=3)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == (B, HW, HW, 3)
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    assert not np.allclose(got["imgs_1step"].numpy(),
                           got["imgs_final"].numpy())


def test_two_structure_branches_match():
    """A branch_num = 2 prior: a list of two structure images, one encode
    and one lw_depth term each; the further branch's draws are the JAX
    side's folded keys, injected as latent_eps["depth1"] and the second
    depth noise."""
    from humangaussian_torch.convert import unet_state_dict_from_flax
    from humangaussian_torch.guidance import unet as port_unet
    from humangaussian_tpu.guidance import unet as jax_unet
    from humangaussian_tpu.guidance.dual_branch import per_sample_normal
    from port_parity import _jitter, flax_leaves

    jg, pg = tiny_guidance_pair(seed=0)
    jcfg = dataclasses.replace(jax_unet.TINY_TEST_CONFIG, branch_num=2)
    module = jax_unet.DualBranchUNet(jcfg)
    z = jnp.zeros((1, LAT, LAT, 8))
    leaves = _jitter(flax_leaves(module.init(
        jax.random.PRNGKey(3), z, [z, z], jnp.zeros((1,)),
        jnp.zeros((1, 7, 32)), jnp.zeros((1, 6)))), np.random.RandomState(4))
    punet = port_unet.DualBranchUNet(dataclasses.replace(
        port_unet.TINY_TEST_CONFIG, branch_num=2))
    punet.load_state_dict(unet_state_dict_from_flax(leaves))
    jg = jg.replace(unet=module, unet_params=jax.tree.map(jnp.asarray,
                                                          leaves))
    pg = port_db.DualBranchGuidance(punet, pg.vae, pg.schedule, pg.cfg)

    pose, rgb, depth, text = _scene(seed=12)
    depth2 = np.random.RandomState(13).rand(*depth.shape).astype(np.float32)
    key = jax.random.PRNGKey(23)

    def jcall(rgb_, d1, d2):
        out = jg(jnp.asarray(pose), rgb_, [d1, d2], jnp.asarray(text),
                 jnp.asarray(T, jnp.int32), key)
        return out["loss_sds"], out

    (jl, jout), jgrads = jax.value_and_grad(
        jcall, argnums=(0, 1, 2), has_aux=True)(
            jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(depth2))
    eps = {k: torch.from_numpy(v)
           for k, v in jax_guidance_draws(jg, key, B, LAT).items()}
    idx = jnp.arange(B, dtype=jnp.int32)
    _, k_depth, _, k_grad = jax.random.split(key, 4)
    _, k_dnoise = jax.random.split(k_grad)
    shape = (B, LAT, LAT, 4)
    eps["depth1"] = torch.from_numpy(np.array(per_sample_normal(
        jax.random.fold_in(k_depth, 1), idx, shape)))
    dnoise1 = torch.from_numpy(np.array(per_sample_normal(
        jax.random.fold_in(k_dnoise, 1), idx, shape)))
    ins = [torch.tensor(x, requires_grad=True) for x in (rgb, depth, depth2)]
    out = pg(torch.from_numpy(pose), ins[0], ins[1:], torch.from_numpy(text),
             torch.from_numpy(T), latent_eps=eps, noise=eps["noise"],
             depth_noise=[eps["dnoise"], dnoise1])
    out["loss_sds"].backward()
    assert out["grad"].shape == (B, LAT, LAT, 12)
    assert float(out["loss_sds"].detach()) == pytest.approx(float(jl),
                                                            rel=2e-4)
    _close(out["grad"], jout["grad"], "grad, two branches")
    for x, w, name in zip(ins, jgrads, ("rgb", "depth", "depth2")):
        _close(x.grad, w, f"d(loss)/d({name})")
    with pytest.raises(ValueError, match="structure images"):
        pg(torch.from_numpy(pose), ins[0], ins[1], torch.from_numpy(text),
           torch.from_numpy(T))
