"""Diffusion noise schedule: DDPM / DDIM math on torch tensors.

Port of humangaussian_tpu/guidance/schedule.py: scaled-linear betas
(SD2-base: 0.00085 -> 0.012 over 1000 steps), v-prediction, the
zero-terminal-SNR rescale (Lin et al., "Common Diffusion Noise Schedules and
Sample Steps are Flawed") and trailing timestep spacing for inference. The
rescaled `alphas_cumprod` is what the guidance reads for `add_noise` and
for the SDS weight w(t) = 1 - alpha_bar_t.

The tables are built in float64 numpy, as the reference builds them, and
held as one float32 tensor on the device. Timesteps `t` are integer tensors
[B] on that device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from humangaussian_torch import resolve_device


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift and scale sqrt(alpha_bar) so that the terminal step has SNR
    exactly 0 while step 0 is preserved (diffusers'
    rescale_zero_terminal_snr)."""
    abar_sqrt = np.sqrt(alphas_cumprod)
    a_first = abar_sqrt[0]
    a_last = abar_sqrt[-1]
    abar_sqrt = abar_sqrt - a_last
    abar_sqrt = abar_sqrt * a_first / (a_first - a_last)
    return abar_sqrt**2


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    """Immutable schedule tables."""

    alphas_cumprod: torch.Tensor  # [T] float32
    num_train_timesteps: int = 1000
    prediction_type: str = "v_prediction"

    @classmethod
    def create(
        cls,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        rescale_betas_zero_snr: bool = True,
        prediction_type: str = "v_prediction",
        device="cuda",
    ) -> "DiffusionSchedule":
        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start**0.5, beta_end**0.5,
                                num_train_timesteps, dtype=np.float64) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                                dtype=np.float64)
        elif beta_schedule == "squaredcos_cap_v2":
            def abar(u):
                return np.cos((u + 0.008) / 1.008 * np.pi / 2) ** 2

            ts = np.arange(num_train_timesteps, dtype=np.float64)
            betas = np.minimum(
                1.0 - abar((ts + 1) / num_train_timesteps)
                / abar(ts / num_train_timesteps), 0.999)
        else:
            raise ValueError(f"unknown beta schedule {beta_schedule!r}")
        alphas_cumprod = np.cumprod(1.0 - betas)
        if rescale_betas_zero_snr:
            alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)
        return cls(
            alphas_cumprod=torch.from_numpy(
                alphas_cumprod.astype(np.float32)).to(resolve_device(device)),
            num_train_timesteps=num_train_timesteps,
            prediction_type=prediction_type,
        )

    def _coeffs(self, abar, ndim):
        shape = (-1,) + (1,) * (ndim - 1)
        return (torch.sqrt(abar).reshape(shape),
                torch.sqrt(1.0 - abar).reshape(shape))

    # ---- noising -----------------------------------------------------
    def add_noise(self, x0, noise, t):
        """q(x_t | x_0): sqrt(abar) x0 + sqrt(1 - abar) eps. t: [B] int."""
        sa, s1a = self._coeffs(self.alphas_cumprod[t], x0.dim())
        return sa * x0 + s1a * noise

    def get_velocity(self, x0, noise, t):
        """v-target: sqrt(abar) eps - sqrt(1 - abar) x0."""
        sa, s1a = self._coeffs(self.alphas_cumprod[t], x0.dim())
        return sa * noise - s1a * x0

    def sds_weight(self, t, strategy: str = "sds"):
        """w(t): `sds` 1 - abar, `uniform` 1, `fantasia3d`
        sqrt(abar) (1 - abar)."""
        abar = self.alphas_cumprod[t]
        if strategy == "sds":
            return 1.0 - abar
        if strategy == "uniform":
            return torch.ones_like(abar)
        if strategy == "fantasia3d":
            return torch.sqrt(abar) * (1.0 - abar)
        raise ValueError(f"unknown weighting strategy {strategy!r}")

    # ---- model-output conversions ------------------------------------
    def pred_original(self, model_out, x_t, t):
        """x0-hat from a model output under this prediction type."""
        sa, s1a = self._coeffs(self.alphas_cumprod[t], x_t.dim())
        if self.prediction_type == "v_prediction":
            return sa * x_t - s1a * model_out
        if self.prediction_type == "epsilon":
            return (x_t - s1a * model_out) / sa
        raise ValueError(self.prediction_type)

    def pred_epsilon(self, model_out, x_t, t):
        """eps-hat from a model output under this prediction type."""
        sa, s1a = self._coeffs(self.alphas_cumprod[t], x_t.dim())
        if self.prediction_type == "v_prediction":
            return sa * model_out + s1a * x_t
        if self.prediction_type == "epsilon":
            return model_out
        raise ValueError(self.prediction_type)

    # ---- DDIM sampling ------------------------------------------------
    def trailing_timesteps(self, num_inference_steps: int) -> np.ndarray:
        """'trailing' spacing, descending from T - 1."""
        step = self.num_train_timesteps / num_inference_steps
        return np.round(
            np.arange(self.num_train_timesteps, 0, -step)
        ).astype(np.int64) - 1

    def ddim_step(self, model_out, x_t, t, t_prev):
        """Deterministic DDIM update x_t -> x_{t_prev} (eta = 0); a
        negative t_prev is the final step (alpha_bar_prev = 1)."""
        x0 = self.pred_original(model_out, x_t, t)
        eps = self.pred_epsilon(model_out, x_t, t)
        abar_prev = torch.where(
            t_prev >= 0, self.alphas_cumprod[t_prev.clamp_min(0)],
            torch.ones((), device=x_t.device))
        sa, s1a = self._coeffs(abar_prev, x_t.dim())
        return sa * x0 + s1a * eps


def if_schedule(num_train_timesteps: int = 1000,
                device="cuda") -> DiffusionSchedule:
    """DeepFloyd IF's DDPM schedule: cosine (squaredcos_cap_v2) betas,
    epsilon prediction, no zero-SNR rescale."""
    return DiffusionSchedule.create(
        num_train_timesteps=num_train_timesteps,
        beta_schedule="squaredcos_cap_v2", rescale_betas_zero_snr=False,
        prediction_type="epsilon", device=device)


def sd_eps_schedule(num_train_timesteps: int = 1000,
                    device="cuda") -> DiffusionSchedule:
    """SD 2.1-base's schedule: scaled-linear betas, epsilon prediction, no
    zero-SNR rescale."""
    return DiffusionSchedule.create(
        num_train_timesteps=num_train_timesteps,
        rescale_betas_zero_snr=False, prediction_type="epsilon",
        device=device)
