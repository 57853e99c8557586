"""DPM-Solver++ sampling, the path `sample_dpm` takes (mirrors
the JAX package's ops/dpm_solver.py:35-117, 143-…): method "singlestep",
order 3, skip_type "time_uniform", algorithm_type "dpmsolver++",
solver_type "dpmsolver", with `correcting_x0_fn`. The time grid, the
per-step alphas/sigmas/log-SNRs and every Runge-Kutta coefficient are
float64 numpy scalars computed on the host, so the device runs only the
model calls and the linear combinations. The multistep, singlestep_fixed
and adaptive methods of the JAX package are not ported yet.
"""

import math

import numpy as np
import torch

# What `sample_denoiser` computes, named: a `sample` artifact records it and
# `serving.load_artifact` refuses one recorded with another name. Change it
# whenever a change here would move a sample's output.
SAMPLER = "dpmsolver++-singlestep-order3-time_uniform-v1"


class VPSchedule:
    """Continuous-time view of a discrete beta schedule. Times and
    coefficients are Python floats (float64), so they scale tensors
    without changing their dtype."""

    def __init__(self, betas):
        betas = np.asarray(betas, np.float64)
        self.N = len(betas)
        self.T = 1.0
        self.t_array = (np.arange(self.N) + 1.0) / self.N
        self.log_alpha_array = 0.5 * np.cumsum(np.log(1.0 - betas))

    def log_alpha(self, t):
        return float(np.interp(t, self.t_array, self.log_alpha_array))

    def alpha(self, t):
        return math.exp(self.log_alpha(t))

    def sigma(self, t):
        return math.sqrt(1.0 - math.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * math.log(1.0 - math.exp(2.0 * la))

    def inverse_lambda(self, lam):
        # lambda -> log_alpha analytically, then t over the log_alpha knots
        log_alpha = -0.5 * float(np.logaddexp(0.0, -2.0 * lam))
        return float(np.interp(log_alpha, self.log_alpha_array[::-1],
                               self.t_array[::-1]))


def _singlestep_orders(steps, order):
    if order == 3:
        K = steps // 3 + 1
        if steps % 3 == 0:
            return [3] * (K - 2) + [2, 1]
        if steps % 3 == 1:
            return [3] * (K - 1) + [1]
        return [3] * (K - 1) + [2]
    if order == 2:
        return [2] * (steps // 2) + ([1] if steps % 2 else [])
    if order == 1:
        return [1] * steps
    raise ValueError(order)


def dpm_solver_sample(model_fn, betas, x_T, steps=20, order=3,
                      model_type="eps", correcting_x0_fn=None):
    """x_0 from x_T by singlestep DPM-Solver++ (time-uniform grid).

    model_fn(x, t_continuous: float) -> model output of `model_type`
    ("eps", "x0" or "v"); correcting_x0_fn is applied to every predicted x0.
    """
    ns = VPSchedule(betas)
    t_0, t_T = 1.0 / ns.N, ns.T

    def m_fn(x, t):
        out = model_fn(x, t)
        a, s = ns.alpha(t), ns.sigma(t)
        if model_type == "eps":
            x0 = (x - s * out) / a
        elif model_type == "v":
            x0 = a * x - s * out
        elif model_type == "x0":
            x0 = out
        else:
            raise ValueError(model_type)
        if correcting_x0_fn is not None:
            x0 = correcting_x0_fn(x0)
        return x0

    def update_1(x, m_s, s, t):
        h = ns.lam(t) - ns.lam(s)
        return (ns.sigma(t) / ns.sigma(s)) * x \
            - (ns.alpha(t) * math.expm1(-h)) * m_s

    def update_2(x, m_s, s, t, r1):
        lam_s, lam_t = ns.lam(s), ns.lam(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        x_s1 = (ns.sigma(s1) / ns.sigma(s)) * x \
            - (ns.alpha(s1) * math.expm1(-r1 * h)) * m_s
        m_s1 = m_fn(x_s1, s1)
        phi_1 = math.expm1(-h)
        base = (ns.sigma(t) / ns.sigma(s)) * x \
            - (ns.alpha(t) * phi_1) * m_s
        return base - (0.5 / r1) * (ns.alpha(t) * phi_1) * (m_s1 - m_s)

    def update_3(x, m_s, s, t, r1, r2):
        lam_s, lam_t = ns.lam(s), ns.lam(t)
        h = lam_t - lam_s
        s1 = ns.inverse_lambda(lam_s + r1 * h)
        s2 = ns.inverse_lambda(lam_s + r2 * h)
        phi_11 = math.expm1(-r1 * h)
        phi_12 = math.expm1(-r2 * h)
        phi_1 = math.expm1(-h)
        phi_22 = math.expm1(-r2 * h) / (r2 * h) + 1.0
        phi_2 = phi_1 / h + 1.0
        x_s1 = (ns.sigma(s1) / ns.sigma(s)) * x \
            - (ns.alpha(s1) * phi_11) * m_s
        m_s1 = m_fn(x_s1, s1)
        x_s2 = (ns.sigma(s2) / ns.sigma(s)) * x \
            - (ns.alpha(s2) * phi_12) * m_s \
            + (r2 / r1) * (ns.alpha(s2) * phi_22) * (m_s1 - m_s)
        m_s2 = m_fn(x_s2, s2)
        base = (ns.sigma(t) / ns.sigma(s)) * x \
            - (ns.alpha(t) * phi_1) * m_s
        return base + (1.0 / r2) * (ns.alpha(t) * phi_2) * (m_s2 - m_s)

    orders = _singlestep_orders(steps, order)
    full = np.linspace(t_T, t_0, steps + 1)
    t_outer = full[np.cumsum([0] + orders)]
    x = x_T
    for i, ord_i in enumerate(orders):
        s, t = float(t_outer[i]), float(t_outer[i + 1])
        # r1/r2 from the lambdas of the time-uniform inner grid
        lam_s = ns.lam(s)
        h = ns.lam(t) - lam_s
        inner = [float(u) for u in np.linspace(s, t, ord_i + 1)]
        m_s = m_fn(x, s)
        if ord_i == 1:
            x = update_1(x, m_s, s, t)
        elif ord_i == 2:
            x = update_2(x, m_s, s, t, (ns.lam(inner[1]) - lam_s) / h)
        else:
            x = update_3(x, m_s, s, t,
                         (ns.lam(inner[1]) - lam_s) / h,
                         (ns.lam(inner[2]) - lam_s) / h)
    return x


def sample_denoiser(denoise, betas, x_T, cond, steps=20, order=3,
                    model_type="eps", correcting_x0_fn=None):
    """`dpm_solver_sample` over a conditional denoiser in model time:
    `denoise(x, t [B], cond)` is called at t = (t_continuous - 1/N) * 1000
    for a schedule of N = len(betas) steps (`CondDDPM.sample_dpm`'s
    conversion, at any N), with t filled on x's device from a host
    float, so no step waits on the device."""
    n = len(betas)

    def model_fn(x, t_cont):
        t = torch.full((x.shape[0],), (t_cont - 1.0 / n) * 1000.0,
                       dtype=torch.float32, device=x.device)
        return denoise(x, t, cond)

    return dpm_solver_sample(model_fn, betas, x_T, steps=steps, order=order,
                             model_type=model_type,
                             correcting_x0_fn=correcting_x0_fn)
