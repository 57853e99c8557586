"""Diffusion schedule tables (mirrors the JAX package's models/schedules.py:
16-116): the four beta schedules, the per-timestep coefficient tables
(float64 math, stored as f32, as the JAX tables are) and the DDIM
timestep subset and its sampling parameters. Plain numpy; the decoder
keeps the tables as non-persistent buffers."""

import math
from typing import NamedTuple

import numpy as np


def make_beta_schedule(schedule, n_timestep, linear_start=1e-4,
                       linear_end=2e-2, cosine_s=8e-3):
    """Betas in float64: "linear" (sqrt-interpolated), "cosine",
    "sqrt_linear" or "sqrt"."""
    if schedule == "linear":
        return np.linspace(linear_start ** 0.5, linear_end ** 0.5,
                           n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = (np.arange(n_timestep + 1, dtype=np.float64) / n_timestep
                 + cosine_s)
        alphas = np.cos(steps / (1 + cosine_s) * math.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1 - alphas[1:] / alphas[:-1], 0, 0.999)
    if schedule == "sqrt_linear":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64)
    if schedule == "sqrt":
        return np.linspace(linear_start, linear_end, n_timestep,
                           dtype=np.float64) ** 0.5
    raise ValueError(f"unknown beta schedule {schedule!r}")


class GaussianSchedule(NamedTuple):
    """The per-timestep coefficients, f32 arrays of length T."""

    betas: np.ndarray
    alphas_bar: np.ndarray
    alphas_bar_prev: np.ndarray
    sqrt_alphas_bar: np.ndarray
    sqrt_one_minus_alphas_bar: np.ndarray
    log_one_minus_alphas_bar: np.ndarray
    sqrt_recip_alphas_bar: np.ndarray
    sqrt_recipm1_alphas_bar: np.ndarray
    posterior_variance: np.ndarray
    posterior_log_variance_clipped: np.ndarray
    posterior_mean_coef1: np.ndarray
    posterior_mean_coef2: np.ndarray

    @property
    def num_timesteps(self):
        return self.betas.shape[0]


def make_gaussian_schedule(schedule="linear", timesteps=1000,
                           linear_start=1e-4, linear_end=2e-2,
                           cosine_s=8e-3):
    betas = make_beta_schedule(schedule, timesteps, linear_start, linear_end,
                               cosine_s)
    alphas = 1.0 - betas
    alphas_bar = np.cumprod(alphas, axis=0)
    alphas_bar_prev = np.append(1.0, alphas_bar[:-1])
    posterior_variance = betas * (1.0 - alphas_bar_prev) / (1.0 - alphas_bar)

    def f32(a):
        return np.asarray(a, np.float32)

    return GaussianSchedule(
        betas=f32(betas),
        alphas_bar=f32(alphas_bar),
        alphas_bar_prev=f32(alphas_bar_prev),
        sqrt_alphas_bar=f32(np.sqrt(alphas_bar)),
        sqrt_one_minus_alphas_bar=f32(np.sqrt(1.0 - alphas_bar)),
        log_one_minus_alphas_bar=f32(np.log(1.0 - alphas_bar)),
        sqrt_recip_alphas_bar=f32(np.sqrt(1.0 / alphas_bar)),
        sqrt_recipm1_alphas_bar=f32(np.sqrt(1.0 / alphas_bar - 1.0)),
        posterior_variance=f32(posterior_variance),
        posterior_log_variance_clipped=f32(
            np.log(np.maximum(posterior_variance, 1e-20))),
        posterior_mean_coef1=f32(
            betas * np.sqrt(alphas_bar_prev) / (1.0 - alphas_bar)),
        posterior_mean_coef2=f32(
            (1.0 - alphas_bar_prev) * np.sqrt(alphas) / (1.0 - alphas_bar)),
    )


def make_ddim_timesteps(num_ddim_steps, num_ddpm_steps, method="uniform"):
    """The DDIM subset of the DDPM timesteps, shifted by +1 ("uniform"
    or "quad" spacing)."""
    if method == "uniform":
        steps = np.arange(0, num_ddpm_steps, num_ddpm_steps // num_ddim_steps)
    elif method == "quad":
        steps = (np.linspace(0, np.sqrt(num_ddpm_steps * 0.8),
                             num_ddim_steps) ** 2).astype(int)
    else:
        raise ValueError(method)
    return steps + 1


def make_ddim_sampling_parameters(alphacums, ddim_timesteps, eta):
    """(sigma, alpha, alpha_prev) of each DDIM step, f32."""
    alphas = alphacums[ddim_timesteps]
    alphas_prev = np.concatenate(
        [alphacums[:1], alphacums[ddim_timesteps[:-1]]])
    sigmas = eta * np.sqrt((1 - alphas_prev) / (1 - alphas) *
                           (1 - alphas / alphas_prev))
    return (np.asarray(sigmas, np.float32), np.asarray(alphas, np.float32),
            np.asarray(alphas_prev, np.float32))
