"""The port's DreamFusion system (humangaussian_torch/nerf/system.py) and its
launcher path against the JAX package on the CPU, with the tiny SD
guidance pair (TINY_SINGLE_CONFIG, the tiny VAE, 16^2 renders, 8^2
latents) and one Flax init of the field carried over by
`convert.nerf_state_dict_from_flax`. The JAX step is
`jax.value_and_grad(system.loss_fn)` under `jax.jit` (its compile takes a
fifth of the op-by-op run; `train_step` itself is not used) and then
`optax.adam`, and its draws
(cameras, timesteps, per-camera render jitter, the encode's eps and the
gradient's noise) are handed to the port.

Tolerances: one step's loss 1e-5 relative, every parameter gradient 1e-4 of
its leaf's max |grad|; the port's Adam (`torch.optim.Adam`) against
`optax.adam` on the same gradient tree over 3 updates 1e-6 absolute; after
two whole steps every parameter within 1e-5, except the hash-table entries
whose gradient the two packages resolve to no better than 2e-4 of its own
magnitude at either step. Adam normalizes each entry by its own magnitude
(at step 1 it moves by about lr sign(g)), so an entry moves by lr times
its gradient's relative error, up to 2 lr where a near-zero sum changes
sign between the packages' summation orders; 2e-4 keeps lr times it below
1e-5 over two steps. The gradients themselves are held to 1e-4 of the
max above. The test prints how many entries it leaves out.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from humangaussian_torch.convert import (
    nerf_state_dict_from_flax,
    prompt_embeddings_from_numpy,
)
from humangaussian_torch.data import cameras as pcams
from humangaussian_torch.guidance import stable_diffusion as port_sd
from humangaussian_torch.guidance.schedule import sd_eps_schedule
from humangaussian_torch.nerf import encoding as penc
from humangaussian_torch.nerf import geometry as pgeo
from humangaussian_torch.nerf import renderer as pren
from humangaussian_torch.nerf import system as psys
from humangaussian_tpu.data import cameras as jcams
from humangaussian_tpu.guidance import prompt as jax_prompt
from humangaussian_tpu.guidance import stable_diffusion as jax_sd
from humangaussian_tpu.guidance.dual_branch import (
    per_sample_normal,
    sample_timesteps,
)
from humangaussian_tpu.nerf import encoding as jenc
from humangaussian_tpu.nerf import geometry as jgeo
from humangaussian_tpu.nerf import renderer as jren
from humangaussian_tpu.nerf import system as jsys
from humangaussian_tpu.ops import groupnorm as jax_gn
from port_parity import (
    jax_render_draws,
    nerf_leaves,
    np_,
    tiny_prompt_arrays,
    tiny_single_unet_pair,
    tiny_vae_pair,
    torch_camera_batch,
)

torch.set_num_threads(1)
B, HW, LAT = 2, 16, 8
HASH = dict(n_levels=4, log2_hashmap_size=12, base_resolution=4)
GEO = dict(n_neurons=16, n_hidden_layers=1)


@pytest.fixture(autouse=True)
def pallas(monkeypatch):
    monkeypatch.setattr(jax_gn, "FORCE_PALLAS_INTERPRET", True)


def system_pair(seed=0, samples=16, **cfg):
    """(JAX system, port system, numpy field leaves) sharing the tiny
    prior, the prompt embeddings and the field."""
    jun, jup, pun = tiny_single_unet_pair(seed=0)
    jvae, jvp, pvae = tiny_vae_pair(seed=0)
    gkw = dict(latent_size=LAT, image_size=HW, guidance_scale=7.5)
    jg = jax_sd.StableDiffusionGuidance(
        unet=jun, unet_params=jup, vae=jvae, vae_params=jvp,
        schedule=jax_sd.sd_eps_schedule(), cfg=jax_sd.SDGuidanceConfig(**gkw))
    pg = port_sd.StableDiffusionGuidance(pun, pvae,
                                         sd_eps_schedule(device="cpu"),
                                         port_sd.SDGuidanceConfig(**gkw))
    arrays = tiny_prompt_arrays(1)
    rcfg = dict(num_samples_per_ray=samples,
                num_importance_samples=cfg.pop("importance", 0))
    js = jsys.DreamFusionSystem(
        jsys.DreamFusionConfig(
            geometry=jgeo.ImplicitVolumeConfig(
                hash_cfg=jenc.HashGridConfig(**HASH), **GEO),
            renderer=jren.RendererConfig(**rcfg), **cfg),
        jg, jax_prompt.PromptEmbeddings(**{k: jnp.asarray(v)
                                           for k, v in arrays.items()}),
        camera_cfg=jcams.RandomCameraConfig(batch_size=B, height=HW,
                                            width=HW))
    ps = psys.DreamFusionSystem(
        psys.DreamFusionConfig(
            geometry=pgeo.ImplicitVolumeConfig(
                hash_cfg=penc.HashGridConfig(**HASH), **GEO),
            renderer=pren.RendererConfig(**rcfg), **cfg),
        pg, prompt_embeddings_from_numpy(arrays, device="cpu"),
        camera_cfg=pcams.RandomCameraConfig(batch_size=B, height=HW,
                                            width=HW),
        device="cpu")
    leaves = nerf_leaves(js.renderer.init_params(jax.random.PRNGKey(seed)),
                         seed, table_scale=0.05)
    ps.renderer.field.load_state_dict(nerf_state_dict_from_flax(leaves))
    return js, ps, leaves


def jax_step_draws(js, key, step):
    """The JAX train_step's draws from `key` at `step`: (next key, JAX
    cameras, JAX t, the loss key, the port's DFStepInputs)."""
    key, k_cam, k_t, k_loss = jax.random.split(key, 4)
    cams = jcams.sample_camera_batch(k_cam, step, js.camera_cfg)
    t = sample_timesteps(k_t, B, int(0.02 * 1000), int(0.98 * 1000) - 1)
    k_render, k_guide = jax.random.split(k_loss)
    rc = js.cfg.renderer
    draws = [jax_render_draws(k, HW * HW, rc.num_samples_per_ray,
                              rc.num_importance_samples)
             for k in jax.random.split(k_render, B)]
    idx = jnp.arange(B, dtype=jnp.int32)
    k_enc, k_noise = jax.random.split(k_guide)
    eps, noise = (torch.from_numpy(np.array(per_sample_normal(
        k, idx, (B, LAT, LAT, 4)))) for k in (k_enc, k_noise))
    inputs = psys.DFStepInputs(
        cameras=torch_camera_batch(cams), t=torch.from_numpy(np.array(t)),
        jitter=torch.stack([d[0] for d in draws]),
        fine_u=(torch.stack([d[1] for d in draws])
                if rc.num_importance_samples else None),
        latent_eps=eps, noise=noise)
    return key, cams, t, k_loss, inputs


def loss_and_grads(js):
    return jax.jit(jax.value_and_grad(js.loss_fn, has_aux=True))


def assert_grads(got: dict, jax_grads, rel=1e-4):
    want = nerf_state_dict_from_flax(jax.tree.map(np.asarray, jax_grads))
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        w = w.numpy()
        np.testing.assert_allclose(
            np_(got[k]), w, rtol=0, atol=rel * float(np.abs(w).max()) + 1e-12,
            err_msg=k)


CASES = {
    "default": dict(),
    "normals-opaque-importance": dict(render_normals=True,
                                      lambda_opaque=0.3, lambda_orient=0.5,
                                      importance=8),
}


class TestDreamFusionSystem:
    """One step's loss and gradients, the Adam update, two whole steps,
    the sampled step and render_eval, the seeded init."""

    @pytest.fixture(scope="module", params=list(CASES))
    def one_step(self, request):
        """One JAX step's loss and gradients, and the port's on the same
        draws."""
        js, ps, leaves = system_pair(**dict(CASES[request.param]))
        params = jax.tree.map(jnp.asarray, leaves)
        _, cams, t, k_loss, inputs = jax_step_draws(js, jax.random.PRNGKey(5), 0)
        (loss, metrics), grads = loss_and_grads(js)(
            params, cams, t, js.prompt_embeddings, k_loss)
        got = ps.loss_and_grads(inputs)
        return request.param, (loss, metrics, grads), got


    def test_step_loss_matches(self, one_step):
        _, (loss, metrics, _), (got_loss, got_metrics, _) = one_step
        assert float(got_loss) == pytest.approx(float(loss), rel=1e-5)
        for k in ("loss_sds", "loss_sparsity"):
            assert float(got_metrics[k]) == pytest.approx(float(metrics[k]),
                                                          rel=1e-5), k


    def test_step_gradients_match(self, one_step):
        name, (_, _, grads), (_, _, got) = one_step
        assert_grads(got, grads)
        # every part of the field learns
        for part in ("geometry.encoding.table", "geometry.density_network.out",
                     "geometry.feature_network.out", "background.mlp.out"):
            assert any(float(g.abs().max()) > 0 for k, g in got.items()
                       if k.startswith(part)), (name, part)


    def test_adam_matches_optax(self):
        """torch.optim.Adam as the system builds it against optax.adam(lr) on
        the same gradient trees, 3 updates."""
        js, ps, leaves = system_pair(seed=1)
        state = ps.init_state(0)
        ps.renderer.field.load_state_dict(nerf_state_dict_from_flax(leaves))
        params = jax.tree.map(jnp.asarray, leaves)
        opt = optax.adam(js.cfg.learning_rate)
        opt_state = opt.init(params)
        rs = np.random.RandomState(2)
        for _ in range(3):
            g = jax.tree.map(lambda x: jnp.asarray(
                rs.randn(*x.shape).astype(np.float32) * 10.0 ** rs.uniform(-9, 1,
                                                                         x.shape)
            ), params)
            updates, opt_state = opt.update(g, opt_state, params)
            params = optax.apply_updates(params, updates)
            for k, v in nerf_state_dict_from_flax(jax.tree.map(np.asarray,
                                                               g)).items():
                ps.params[k].grad = v
            state.optimizer.step()
        want = nerf_state_dict_from_flax(jax.tree.map(np.asarray, params))
        for k, w in want.items():
            np.testing.assert_allclose(np_(ps.params[k]), w.numpy(), rtol=0,
                                       atol=1e-6, err_msg=k)


    def test_two_steps_match(self):
        js, ps, leaves = system_pair(seed=2)
        params = jax.tree.map(jnp.asarray, leaves)
        opt_state = js.optimizer.init(params)
        state = ps.init_state(0)
        ps.renderer.field.load_state_dict(nerf_state_dict_from_flax(leaves))
        key = jax.random.PRNGKey(7)
        jax_loss_and_grads = loss_and_grads(js)
        unresolved = np.zeros(
            leaves["geometry"]["params"]["encoding"]["table"].shape, bool)
        for step in range(2):
            key, cams, t, k_loss, inputs = jax_step_draws(js, key, step)
            (loss, _), grads = jax_loss_and_grads(
                params, cams, t, js.prompt_embeddings, k_loss)
            updates, opt_state = js.optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            gj = np.asarray(grads["geometry"]["params"]["encoding"]["table"])
            gp = np_(ps.loss_and_grads(inputs)[2]["geometry.encoding.table"])
            unresolved |= np.abs(gp - gj) > 2e-4 * np.abs(gj)
            state, metrics = ps.train_step(state, inputs)
            assert float(metrics["loss"]) == pytest.approx(float(loss), rel=1e-5)
        assert state.step == 2
        print(f"hash entries left out (gradients apart by more than 2e-4 of "
              f"their magnitude): {int(unresolved.sum())} of {unresolved.size}")
        want = nerf_state_dict_from_flax(jax.tree.map(np.asarray, params))
        for k, w in want.items():
            got, w = np_(ps.params[k]), w.numpy()
            keep = ~unresolved if k == "geometry.encoding.table" else np.ones_like(
                w, bool)
            np.testing.assert_allclose(got[keep], w[keep], rtol=0, atol=1e-5,
                                       err_msg=k)


    def test_sampled_step_and_render_eval(self):
        """The step with its own draws (the state's generator) runs, moves
        every part of the field and keeps it finite; render_eval is
        deterministic and equals JAX's on the same parameters."""
        js, ps, leaves = system_pair(seed=3)
        state = ps.init_state(4)
        ps.renderer.field.load_state_dict(nerf_state_dict_from_flax(leaves))
        c2w = np.eye(4, dtype=np.float32)
        c2w[2, 3] = 2.5
        want = js.render_eval(js.init_state(jax.random.PRNGKey(0))._replace(
            params=jax.tree.map(jnp.asarray, leaves)), jnp.asarray(c2w), 0.8,
            12, 12)
        got = ps.render_eval(state, torch.from_numpy(c2w), 0.8, 12, 12)
        for k in ("comp_rgb", "opacity"):
            np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]), rtol=0,
                                       atol=1e-5 * float(np.abs(want[k]).max()))
        before = {k: v.detach().clone() for k, v in ps.params.items()}
        for _ in range(2):
            state, metrics = ps.train_step(state)
        assert state.step == 2 and np.isfinite(float(metrics["loss"]))
        for k, v in ps.params.items():
            assert bool(torch.isfinite(v).all()), k
            assert not torch.equal(v, before[k]), k


    def test_init_state_is_seeded(self):
        _, ps, _ = system_pair()
        ps.init_state(3)
        a = {k: v.detach().clone() for k, v in ps.params.items()}
        ps.init_state(3)
        for k, v in ps.params.items():
            assert torch.equal(v, a[k]), k
        assert float(ps.params["geometry.encoding.table"].detach().abs().max()
                     ) <= 1e-4
        assert ps.timestep_range == (20, 979)


# ---- the CLI ----------------------------------------------------------------

TINY_OVERRIDES = [
    "trainer.max_steps=2",
    "data.batch_size=1", "data.height=16", "data.width=16",
    "data.eval_height=16",
    "system.renderer.num_samples_per_ray=8",
    "system.geometry.n_neurons=8",
    "system.geometry.hash_cfg.n_levels=2",
    "system.geometry.hash_cfg.log2_hashmap_size=8",
]


def run_cli(tmp_path, *extra):
    from humangaussian_torch.apps import launch

    return launch.main([
        "--config", "configs/dreamfusion.yaml", "--train", "--device", "cpu",
        f"exp_root_dir={tmp_path}/out",
        f"system.prompt_processor.cache_dir={tmp_path}/cache",
        *TINY_OVERRIDES, *extra])


@pytest.mark.parametrize("extra", [(), ("system.guidance.use_perp_neg=true",)],
                         ids=["sds", "perp-neg"])
def test_cli_trains_and_writes_orbit(tmp_path, capsys, extra):
    from PIL import Image

    trial = run_cli(tmp_path, "trainer.log_every=1", *extra)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("step ")]
    assert [ln.split(":")[0] for ln in lines] == ["step 1", "step 2"]
    assert all(np.isfinite(float(ln.split("loss=")[1])) for ln in lines)
    orbit = os.path.join(trial, "save", "orbit.png")
    assert Image.open(orbit).size == (8 * 16, 16)


def test_cli_unknown_arch(tmp_path):
    with pytest.raises(ValueError, match="arch"):
        run_cli(tmp_path, "system.guidance.arch=sd3")


def test_build_system_from_config():
    """The shipped config's widths reach the system: 8 levels x 2^16 hash
    table, 32-neuron MLPs, 64 samples a ray, no-material, a solid
    background, batch 2 at 64^2, the tiny prior."""
    from humangaussian_torch.apps import launch
    from humangaussian_torch.config import load_config

    cfg = load_config("configs/dreamfusion.yaml", [
        "system.prompt_processor.use_cache=false"])
    system = launch.build_system(cfg, "cpu")
    assert isinstance(system, psys.DreamFusionSystem)
    geo = system.renderer.geometry
    assert geo.encoding.table.shape == (8, 1 << 16, 2)
    assert geo.density_network.hidden_0.weight.shape == (32, 16)
    assert system.cfg.renderer.num_samples_per_ray == 64
    assert type(system.renderer.material).__name__ == "NoMaterial"
    assert type(system.renderer.background).__name__ == \
        "SolidColorBackground"
    assert system.camera_cfg.batch_size == 2 and system.camera_cfg.height == 64
    assert system.guidance.cfg.image_size == 16
    assert system.prompt_embeddings.text.shape == (7, 32)
    assert dataclasses.asdict(system.cfg)["learning_rate"] == 0.01
