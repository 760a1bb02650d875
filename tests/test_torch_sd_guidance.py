"""guidance/stable_diffusion.py of the port against the JAX package at the
tiny widths (TINY_SINGLE_CONFIG, the tiny VAE, 16^2 images, 8^2 latents),
weights shared through the converters, the JAX side's per-sample draws
injected.

Tolerances: the SDS and Perp-Neg gradients, `grad` and d(loss)/d(rgb)
2e-4 of the reference's max (the guidance chain's tolerance,
tests/test_torch_guidance.py), losses 2e-4 relative, decoded images 1e-4
absolute on [0, 1].
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.guidance import prompt as port_prompt
from humangaussian_torch.guidance import stable_diffusion as port_sd
from humangaussian_torch.guidance.schedule import sd_eps_schedule
from humangaussian_tpu.guidance import prompt as jax_prompt
from humangaussian_tpu.guidance import stable_diffusion as jax_sd
from humangaussian_tpu.guidance.dual_branch import per_sample_normal
from humangaussian_tpu.ops import groupnorm as jax_gn
from port_parity import tiny_prompt_arrays, tiny_single_unet_pair, \
    tiny_vae_pair

torch.set_num_threads(1)
B, HW, LAT = 2, 16, 8
REL = 2e-4
T = np.array([120, 700], np.int64)
ELEV = np.array([10.0, 20.0], np.float32)
AZIM = np.array([30.0, -150.0], np.float32)


@pytest.fixture(autouse=True)
def pallas(monkeypatch):
    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)


def _pair(**cfg):
    jun, jup, pun = tiny_single_unet_pair(seed=0)
    jvae, jvp, pvae = tiny_vae_pair(seed=0)
    kw = dict(latent_size=LAT, image_size=HW, guidance_scale=7.5)
    kw.update(cfg)
    jg = jax_sd.StableDiffusionGuidance(
        unet=jun, unet_params=jup, vae=jvae, vae_params=jvp,
        schedule=jax_sd.sd_eps_schedule(), cfg=jax_sd.SDGuidanceConfig(**kw))
    pg = port_sd.StableDiffusionGuidance(pun, pvae,
                                         sd_eps_schedule(device="cpu"),
                                         port_sd.SDGuidanceConfig(**kw))
    return jg, pg


def _embeddings():
    arrays = tiny_prompt_arrays(1)
    return (jax_prompt.PromptEmbeddings(**{k: jnp.asarray(v)
                                           for k, v in arrays.items()}),
            port_prompt.PromptEmbeddings(**{k: torch.from_numpy(v)
                                            for k, v in arrays.items()}))


def _close(got, want, what, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max(),
                               err_msg=what)


@pytest.mark.parametrize("mode,rescale", [("sds", 0.0), ("sds", 0.7),
                                          ("perp_neg", 0.0)])
def test_sds_gradients_match(mode, rescale):
    jg, pg = _pair(guidance_rescale=rescale)
    jemb, _ = _embeddings()
    rng = np.random.RandomState(3)
    lat = rng.randn(B, LAT, LAT, 4).astype(np.float32)
    noise = rng.randn(B, LAT, LAT, 4).astype(np.float32)
    if mode == "perp_neg":
        text4, neg_w = jax_prompt.get_text_embeddings_perp_neg(
            jemb, jnp.asarray(ELEV), jnp.asarray(AZIM))
        want = jg.compute_grad_sds_perp_neg(
            jnp.asarray(lat), jnp.asarray(T, jnp.int32), text4, neg_w,
            jnp.asarray(noise))
        got = pg.compute_grad_sds_perp_neg(
            torch.from_numpy(lat), torch.from_numpy(T),
            torch.tensor(np.asarray(text4)), torch.tensor(np.asarray(neg_w)),
            torch.from_numpy(noise))
    else:
        text2 = np.array(jemb.get_text_embeddings(
            jnp.asarray(ELEV), jnp.asarray(AZIM)))[: 2 * B]
        want = jg.compute_grad_sds(jnp.asarray(lat),
                                   jnp.asarray(T, jnp.int32),
                                   jnp.asarray(text2), jnp.asarray(noise))
        got = pg.compute_grad_sds(torch.from_numpy(lat), torch.from_numpy(T),
                                  torch.from_numpy(text2),
                                  torch.from_numpy(noise))
    assert got.shape == (B, LAT, LAT, 4)
    _close(got, want, f"{mode} rescale={rescale}")


@pytest.mark.parametrize("use_perp_neg", [False, True])
def test_call_matches(use_perp_neg):
    """The public step through the differentiated VAE encode (recomputed
    in the backward under torch.utils.checkpoint): loss, grad and
    d(loss)/d(rgb) from a 32^2 render."""
    jg, pg = _pair(use_perp_neg=use_perp_neg)
    jemb, pemb = _embeddings()
    rgb = np.random.RandomState(4).rand(B, 32, 32, 3).astype(np.float32)
    key = jax.random.PRNGKey(6)
    clip = 0.3

    def jcall(rgb_):
        out = jg(rgb_, jemb, jnp.asarray(ELEV), jnp.asarray(AZIM),
                 jnp.asarray(T, jnp.int32), key, grad_clip_val=clip)
        return out["loss_sds"], out

    (jl, jout), jgrad = jax.value_and_grad(jcall, has_aux=True)(
        jnp.asarray(rgb))
    idx = jnp.arange(B, dtype=jnp.int32)
    k_enc, k_noise = jax.random.split(key)
    shape = (B, LAT, LAT, 4)
    eps, noise = (torch.from_numpy(np.array(per_sample_normal(k, idx,
                                                              shape)))
                  for k in (k_enc, k_noise))
    rgb_t = torch.tensor(rgb, requires_grad=True)
    out = pg(rgb_t, pemb, torch.from_numpy(ELEV), torch.from_numpy(AZIM),
             torch.from_numpy(T), grad_clip_val=clip, latent_eps=eps,
             noise=noise)
    out["loss_sds"].backward()
    assert float(out["loss_sds"].detach()) == pytest.approx(float(jl),
                                                            rel=2e-4)
    _close(out["grad"], jout["grad"], "grad")
    _close(rgb_t.grad, jgrad, "d(loss)/d(rgb)")
    assert float(rgb_t.grad.abs().max()) > 0


def test_rgb_as_latents_and_decode_match():
    jg, pg = _pair()
    jemb, pemb = _embeddings()
    rng = np.random.RandomState(7)
    rgb = rng.randn(B, 16, 16, 4).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jout = jg(jnp.asarray(rgb), jemb, jnp.asarray(ELEV), jnp.asarray(AZIM),
              jnp.asarray(T, jnp.int32), key, rgb_as_latents=True)
    _k_enc, k_noise = jax.random.split(key)
    noise = torch.from_numpy(np.array(per_sample_normal(
        k_noise, jnp.arange(B, dtype=jnp.int32), (B, LAT, LAT, 4))))
    out = pg(torch.from_numpy(rgb), pemb, torch.from_numpy(ELEV),
             torch.from_numpy(AZIM), torch.from_numpy(T),
             rgb_as_latents=True, noise=noise)
    _close(out["grad"], jout["grad"], "grad, rgb as latents")
    assert float(out["loss_sds"]) == pytest.approx(float(jout["loss_sds"]),
                                                   rel=2e-4)
    lat = rng.randn(B, LAT, LAT, 4).astype(np.float32)
    with torch.no_grad():
        got = pg.decode_latents(torch.from_numpy(lat))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jg.decode_latents(jnp.asarray(lat))), atol=1e-4)
    assert dataclasses.asdict(port_sd.SDGuidanceConfig()) == \
        dataclasses.asdict(jax_sd.SDGuidanceConfig())
