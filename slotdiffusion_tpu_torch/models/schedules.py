"""Diffusion beta schedule (mirrors the JAX package's models/schedules.py:
16-92): the linear (sqrt-interpolated) schedule of the flagship, float64
numpy. The other schedules and the per-step coefficient tables that
training and ancestral/DDIM sampling use are not ported yet."""

import numpy as np


def make_beta_schedule(schedule, n_timestep, linear_start=1e-4,
                       linear_end=2e-2):
    if schedule != "linear":
        raise ValueError(f"beta schedule {schedule!r} is not ported")
    return np.linspace(linear_start ** 0.5, linear_end ** 0.5, n_timestep,
                       dtype=np.float64) ** 2
