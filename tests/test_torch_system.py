"""PyTorch port vs JAX: the avatar trainer's system (train/system.py).

The two systems come from `port_parity.tiny_system_pair` (64^2 renders,
capacity 2048, 500 points, batch 2, the tiny prior with shared weights).
The JAX side runs its own jitted `train_step` once per module; the port
gets the inputs the JAX step drew, rebuilt from the same keys: the camera
unit draws (`jax_camera_draws`), the timestep draw, the guidance's noise
(`jax_guidance_draws`).

Tolerances (NUMERICS.md layer 0, ROADMAP "How each part is held"): the
initial scene 1e-6; cameras 1e-5; pose images, timesteps and text exact;
the loss 1e-5 relative (its sparsity and opaque terms, means of depth
over max depth, 2e-5 absolute: the depth's tolerance); every parameter
gradient and the means2d gradient 2e-4 of that leaf's max |grad| (the
guidance chain's tolerance,
tests/test_torch_guidance.py); the Adam-updated parameters and the densify
statistics 1e-5 (statistics relative to their max); density control as
tests/test_torch_densify.py holds it; `render_eval` 2e-6 on the image and
alpha and 2e-5 on depth, radii exact; checkpoints bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.data.cameras import camera_batch_from_draws
from humangaussian_torch.train import system as port_system
from humangaussian_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from humangaussian_tpu.densify import DensifyState as JDensifyState
from humangaussian_tpu.train import system as jax_system
from port_parity import (
    assert_tree_close,
    dreamer_state_from_jax,
    jax_camera_draws,
    jax_guidance_draws,
    np_,
    tiny_system_pair,
)

torch.set_num_threads(1)
B = 2


@pytest.fixture(scope="module")
def step_pair():
    """One JAX train_step of the tiny system, its gradients, and the
    inputs it drew, rebuilt for the port."""
    js, ps = tiny_system_pair()
    state0 = js.init_state(jax.random.PRNGKey(0), seed=0)
    _key, k_cam, k_t, k_guid = jax.random.split(state0.key, 4)
    _key2, _kg, cams, pose, text3, t = js.sample_step_inputs(state0)

    params = state0.scene.params()
    offset = jnp.zeros((js.cfg.capacity, 2), jnp.float32)

    def loss_fn(p, o):
        return js.batch_loss(p, o, state0.scene, cams, pose, text3, t,
                             k_guid, state0.step, guidance=js.guidance)

    (loss, aux), (pgrads, mgrad) = jax.jit(jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True))(params, offset)
    state1, metrics = js.train_step(state0)
    u = np.array(jax.random.uniform(k_t, (B,)), np.float32)
    draws = {k: torch.from_numpy(v) for k, v in
             jax_guidance_draws(js.guidance, k_guid, B).items()}
    return dict(
        js=js, ps=ps, state0=state0, state1=state1, metrics=metrics,
        loss=float(loss), pgrads=pgrads, mgrad=np.asarray(mgrad),
        cams=cams, pose=np.asarray(pose), t=np.asarray(t),
        text=np.asarray(text3).reshape((3 * B,) + text3.shape[2:]),
        cam_draws=jax_camera_draws(k_cam, B), u=torch.from_numpy(u),
        guidance_draws=dict(latent_eps={k: draws[k]
                                        for k in ("rgb", "depth", "pose")},
                            noise=draws["noise"],
                            depth_noise=draws["dnoise"]))


def _port_inputs(d, ps, step=0):
    cams = camera_batch_from_draws(d["cam_draws"], step, ps.camera_cfg)
    text = ps.prompt_embeddings.get_text_embeddings(
        cams.elevation, cams.azimuth, cams.camera_distances)
    return port_system.StepInputs(
        cameras=cams, pose=ps.pose_images(cams), text=text,
        t=ps.timesteps_from_uniform(d["u"], step),
        guidance_draws=d["guidance_draws"])


def test_init_state_matches(step_pair):
    d = step_pair
    state = d["ps"].init_state(seed=0)
    want = d["state0"].scene
    np.testing.assert_array_equal(np_(state.scene.alive),
                                  np.asarray(want.alive))
    assert_tree_close(state.scene.params(), want.params(), atol=1e-6,
                      what="init")
    assert state.step == 0 and state.adam.count == 0
    assert int(state.scene.alive.sum()) == 500


def test_step_inputs_match(step_pair):
    """Cameras within 1e-5, pose images, timesteps and text exact."""
    d = step_pair
    inputs = _port_inputs(d, d["ps"])
    for f in ("c2w", "mvp_mtx", "elevation", "azimuth", "camera_distances",
              "fovy"):
        np.testing.assert_allclose(np_(getattr(inputs.cameras, f)),
                                   np.asarray(getattr(d["cams"], f)),
                                   atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(np_(inputs.pose), d["pose"])
    np.testing.assert_array_equal(np_(inputs.t), d["t"])
    np.testing.assert_array_equal(np_(inputs.text), d["text"])
    assert float(inputs.pose.max()) > 0


def test_loss_and_gradients_match(step_pair):
    d = step_pair
    ps = d["ps"]
    state = dreamer_state_from_jax(d["state0"])
    loss, aux, pgrads, mgrad = ps.loss_and_grads(state, _port_inputs(d, ps))
    assert float(loss) == pytest.approx(d["loss"], rel=1e-5)
    want = {k: np.asarray(v) for k, v in d["pgrads"].items()}
    want["means2d"] = d["mgrad"]
    got = dict(pgrads, means2d=mgrad)
    assert_tree_close(got, want, scale_rel=2e-4, what="grad")
    for k in ("means", "opacity_logits", "means2d"):
        assert float(got[k].abs().max()) > 0, k


def test_train_step_matches(step_pair):
    """The Adam-updated scene, moments and statistics, and the metrics."""
    d = step_pair
    ps = d["ps"]
    state, metrics = ps.train_step(dreamer_state_from_jax(d["state0"]),
                                   _port_inputs(d, ps))
    want = d["state1"]
    assert state.step == int(want.step) == 1
    assert state.adam.count == int(want.adam.count) == 1
    np.testing.assert_array_equal(np_(state.scene.alive),
                                  np.asarray(want.scene.alive))
    assert_tree_close(state.scene.params(), want.scene.params(), atol=1e-5,
                      what="param")
    assert_tree_close(state.densify._asdict(), want.densify._asdict(),
                      scale_rel=1e-5, what="densify")
    jm = d["metrics"]
    assert set(metrics) == set(jm)
    # the loss 1e-5 relative; its opacity terms are means of depth / max
    # depth, 1-Lipschitz in the depth, so they take the depth's 2e-5
    for k in ("loss", "loss_sds", "grad_norm"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), rel=1e-5), k
    for k in ("loss_sparsity", "loss_opaque"):
        assert float(metrics[k]) == pytest.approx(float(jm[k]), abs=2e-5), k
    assert int(metrics["n_alive"]) == int(jm["n_alive"])
    assert int(metrics["overflow_spill"]) == 0
    assert float(state.densify.grad_accum.max()) > 0


def test_densify_schedule_matches_every_step():
    js = jax_system.GaussianDreamerSystem.__new__(
        jax_system.GaussianDreamerSystem)
    js.cfg = jax_system.GaussianDreamerConfig()
    ps = port_system.GaussianDreamerSystem.__new__(
        port_system.GaussianDreamerSystem)
    ps.cfg = port_system.GaussianDreamerConfig()
    fired = []
    for step in range(3601):
        assert ps.should_densify(step) == js.should_densify(step), step
        assert ps.should_prune_only(step) == js.should_prune_only(step), step
        if ps.should_densify(step) or ps.should_prune_only(step):
            fired.append(step)
    assert fired == [600, 900, 1200, 1500, 1800, 2700, 3000]


def test_densify_and_prune_only_steps_match(step_pair):
    """From statistics well clear of the threshold, with the JAX split draw
    passed in; then prune-only."""
    d = step_pair
    js, ps = d["js"], d["ps"]
    j_state = d["state1"]
    cap = js.cfg.capacity
    rng = np.random.default_rng(5)
    hit = rng.random(cap) < 0.3
    stats = JDensifyState(
        grad_accum=jnp.asarray(np.where(hit, 3e-3, 1e-5), jnp.float32),
        denom=jnp.ones((cap,), jnp.float32),
        max_radii2d=j_state.densify.max_radii2d)
    j_state = j_state._replace(densify=stats)
    t_state = dreamer_state_from_jax(j_state)
    noise = np.array(jax.random.normal(jax.random.split(j_state.key)[1],
                                       (2 * cap, 3)))
    for use_st in (False, True):
        j_new, j_info = js.densify_step(j_state, use_st)
        t_new, t_info = ps.densify_step(t_state, use_st,
                                        noise=torch.from_numpy(noise))
        for k, v in j_info._asdict().items():
            assert int(getattr(t_info, k)) == int(v), (use_st, k)
        assert int(t_info.n_cloned) + int(t_info.n_split) > 0
        np.testing.assert_array_equal(np_(t_new.scene.alive),
                                      np.asarray(j_new.scene.alive))
        assert_tree_close(t_new.scene.params(), j_new.scene.params(),
                          atol=1e-6, what="densify param")
        for name in ("mu", "nu"):
            assert_tree_close(getattr(t_new.adam, name),
                              getattr(j_new.adam, name), scale_rel=1e-5,
                              what=name)
    j_new, j_info = js.prune_only_step(j_new)
    t_new, t_info = ps.prune_only_step(t_new)
    for k, v in j_info._asdict().items():
        assert int(getattr(t_info, k)) == int(v), k
    np.testing.assert_array_equal(np_(t_new.scene.alive),
                                  np.asarray(j_new.scene.alive))
    assert_tree_close(t_new.densify._asdict(), j_new.densify._asdict(),
                      scale_rel=1e-5, what="prune densify")


def test_render_eval_matches_and_chunks_equal_one_batch(step_pair):
    """The 3x3 rect is forced over the training config's 2x2; the orbit in
    chunks of the batch size equals one whole-batch render."""
    import dataclasses

    d = step_pair
    js, ps = d["js"], d["ps"]
    state = dreamer_state_from_jax(d["state1"])
    js.raster_cfg = dataclasses.replace(js.raster_cfg,
                                        max_tiles_per_gaussian=4)
    ps.raster_cfg = dataclasses.replace(ps.raster_cfg,
                                        max_tiles_per_gaussian=4)
    try:
        want, _ = js.render_eval(d["state1"].scene, "test")
        got, cams = ps.render_eval(state.scene, "test")
        assert got["image"].shape == (3, 64, 64, 3)
        np.testing.assert_allclose(np_(got["image"]),
                                   np.asarray(want["image"]), atol=2e-6)
        np.testing.assert_allclose(np_(got["alpha"]),
                                   np.asarray(want["alpha"]), atol=2e-6)
        np.testing.assert_allclose(np_(got["depth"]),
                                   np.asarray(want["depth"]), atol=2e-5)
        np.testing.assert_array_equal(np_(got["radii"]),
                                      np.asarray(want["radii"]))
        whole = ps.render_batch(state.scene, cams, 64, 64,
                                raster_cfg=dataclasses.replace(
                                    ps.raster_cfg,
                                    max_tiles_per_gaussian=9))
        for k in ("image", "depth", "alpha", "radii"):
            assert torch.equal(got[k], whole[k]), k
    finally:
        js.raster_cfg = dataclasses.replace(js.raster_cfg,
                                            max_tiles_per_gaussian=16)
        ps.raster_cfg = dataclasses.replace(ps.raster_cfg,
                                            max_tiles_per_gaussian=16)


def _steps(ps, state, n):
    for _ in range(n):
        state, _ = ps.train_step(state)
        state, _ = ps.maybe_densify(state)
    return state


def _leaves(state) -> dict:
    out = {f"scene.{k}": v for k, v in state.scene._asdict().items()}
    out.update({f"mu.{k}": v for k, v in state.adam.mu.items()})
    out.update({f"nu.{k}": v for k, v in state.adam.nu.items()})
    out.update({f"densify.{k}": v
                for k, v in state.densify._asdict().items()})
    return out


def test_checkpoint_roundtrip_and_resume_bit_equal(step_pair, tmp_path):
    """Save / restore round-trips every leaf, the counts, the generator
    and the per-tile pair cap; 2 steps, save, restore, 1 step equals 3 steps straight (the
    densify pass at step 3 included)."""
    ps = step_pair["ps"]
    straight = _steps(ps, ps.init_state(seed=3), 3)

    two = _steps(ps, ps.init_state(seed=3), 2)
    path = save_checkpoint(str(tmp_path / "ckpt"), two)
    restored = restore_checkpoint(path, ps.init_state(seed=99))
    assert restored.step == 2 and restored.adam.count == 2
    assert restored.tile_cap == two.tile_cap == ps.cfg.tile_capacity
    # a cap that the loop's ladder grew survives the resume
    grown = save_checkpoint(str(tmp_path / "grown"),
                            two._replace(tile_cap=6144))
    assert restore_checkpoint(grown, ps.init_state(seed=99)).tile_cap == 6144
    for k, v in _leaves(two).items():
        assert torch.equal(_leaves(restored)[k], v), k
    assert torch.equal(restored.generator.get_state(),
                       two.generator.get_state())

    resumed = _steps(ps, restored, 1)
    assert resumed.step == straight.step == 3
    assert int(resumed.scene.alive.sum()) > 500  # step 3 cloned
    for k, v in _leaves(straight).items():
        assert torch.equal(_leaves(resumed)[k], v), k


def test_guidance_eval_snapshot_matches(step_pair):
    """The training-time strip from the step's state: the JAX snapshot's
    cameras, encode draw and noise rebuilt from its key splits; render and
    pose as the step holds them, the decoded images within 1e-4 on
    [0, 1]; with no generator given, the state's own generator is left as
    it was."""
    from humangaussian_torch.data.cameras import camera_batch_from_draws

    d = step_pair
    js, ps = d["js"], d["ps"]
    want = js.guidance_eval_snapshot(d["state1"], num_steps=3)
    _key, k_cam, k_enc, k_noise = jax.random.split(d["state1"].key, 4)
    shape = (B, 8, 8, 4)
    eps, noise = (torch.from_numpy(np.array(jax.random.normal(k, shape)))
                  for k in (k_enc, k_noise))
    state = dreamer_state_from_jax(d["state1"])
    cams = camera_batch_from_draws(jax_camera_draws(k_cam, B), 1,
                                   ps.camera_cfg)
    got = ps.guidance_eval_snapshot(state, num_steps=3, cameras=cams,
                                    latent_eps=eps, noise=noise)
    assert set(got) == set(want)
    np.testing.assert_array_equal(np_(got["pose"]), np.asarray(want["pose"]))
    np.testing.assert_allclose(np_(got["render"]),
                               np.asarray(want["render"]), atol=2e-6)
    for k in ("imgs_1step", "imgs_final", "depths_1step", "depths_final"):
        assert got[k].shape == (B, 16, 16, 3)
        np.testing.assert_allclose(np_(got[k]), np.asarray(want[k]),
                                   atol=1e-4, err_msg=k)
    before = state.generator.get_state()
    drawn = ps.guidance_eval_snapshot(state, num_steps=2)
    assert torch.equal(state.generator.get_state(), before)
    assert all(bool(torch.isfinite(v).all()) for v in drawn.values())
