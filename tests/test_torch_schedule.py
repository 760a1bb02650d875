"""guidance/schedule.py and utils/schedules.py of the port against the JAX
package: the tables and every method on the same numpy inputs, 1e-6."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humangaussian_torch.guidance.schedule import DiffusionSchedule as Port
from humangaussian_torch.utils.schedules import C_schedule as port_c
from humangaussian_tpu.guidance.schedule import DiffusionSchedule as Ref
from humangaussian_tpu.utils.schedules import C_schedule as ref_c

torch.set_num_threads(1)
TOL = 1e-6


@pytest.mark.parametrize("kwargs", [
    {},
    {"rescale_betas_zero_snr": False},
    {"beta_schedule": "linear", "prediction_type": "epsilon"},
    {"beta_schedule": "squaredcos_cap_v2", "rescale_betas_zero_snr": False},
    {"num_train_timesteps": 200, "beta_end": 0.02},
])
def test_tables_match(kwargs):
    ref = Ref.create(**kwargs)
    port = Port.create(device="cpu", **kwargs)
    assert port.alphas_cumprod.dtype == torch.float32
    assert port.num_train_timesteps == ref.num_train_timesteps
    assert port.prediction_type == ref.prediction_type
    np.testing.assert_allclose(port.alphas_cumprod.numpy(),
                               np.asarray(ref.alphas_cumprod), atol=TOL)


def test_default_schedule_has_zero_terminal_snr():
    port = Port.create(device="cpu")
    assert float(port.alphas_cumprod[-1]) == 0.0
    with pytest.raises(ValueError):
        Port.create(beta_schedule="cubic", device="cpu")


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(4, 8, 8, 4).astype(np.float32)
    noise = rng.randn(4, 8, 8, 4).astype(np.float32)
    out = rng.randn(4, 8, 8, 4).astype(np.float32)
    t = np.array([0, 120, 700, 998], np.int64)
    return x0, noise, out, t


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
@pytest.mark.parametrize("method", ["add_noise", "get_velocity",
                                    "pred_original", "pred_epsilon"])
def test_methods_match(method, prediction_type):
    ref = Ref.create(prediction_type=prediction_type)
    port = Port.create(prediction_type=prediction_type, device="cpu")
    x0, noise, _, t = _batch()
    want = getattr(ref, method)(jnp.asarray(x0), jnp.asarray(noise),
                                jnp.asarray(t))
    got = getattr(port, method)(torch.from_numpy(x0), torch.from_numpy(noise),
                                torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("strategy", ["sds", "uniform", "fantasia3d"])
def test_sds_weight_matches(strategy):
    ref, port = Ref.create(), Port.create(device="cpu")
    t = np.array([0, 20, 500, 999], np.int64)
    np.testing.assert_allclose(
        port.sds_weight(torch.from_numpy(t), strategy).numpy(),
        np.asarray(ref.sds_weight(jnp.asarray(t), strategy)), atol=TOL)
    with pytest.raises(ValueError):
        port.sds_weight(torch.from_numpy(t), "cubic")


@pytest.mark.parametrize("steps", [1, 4, 50])
def test_trailing_timesteps_match(steps):
    ref, port = Ref.create(), Port.create(device="cpu")
    np.testing.assert_array_equal(port.trailing_timesteps(steps),
                                  ref.trailing_timesteps(steps))


@pytest.mark.parametrize("prediction_type", ["v_prediction", "epsilon"])
def test_ddim_step_matches(prediction_type):
    """Including the final step (t_prev = -1, alpha_bar_prev = 1). t stays
    below the terminal step for epsilon prediction, whose x0 divides by
    sqrt(alpha_bar)."""
    ref = Ref.create(prediction_type=prediction_type)
    port = Port.create(prediction_type=prediction_type, device="cpu")
    x_t, _, out, _ = _batch(1)
    t = np.array([249, 499, 749, 990], np.int64)
    t_prev = np.array([-1, 249, 499, 749], np.int64)
    want = ref.ddim_step(jnp.asarray(out), jnp.asarray(x_t), jnp.asarray(t),
                         jnp.asarray(t_prev))
    got = port.ddim_step(torch.from_numpy(out), torch.from_numpy(x_t),
                         torch.from_numpy(t), torch.from_numpy(t_prev))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL * max(1.0, np.abs(want).max()))


@pytest.mark.parametrize("value", [0.5, 3, [0, 0.98, 0.5, 1500],
                                   [100, 1.0, 4.0, 100]])
@pytest.mark.parametrize("step", [0, 100, 750, 1500, 4000])
def test_c_schedule_matches(value, step):
    assert port_c(value, step) == pytest.approx(float(ref_c(value, step)),
                                                abs=TOL)


def test_c_schedule_rejects_a_short_list():
    with pytest.raises(ValueError):
        port_c([0, 1, 2], 5)
