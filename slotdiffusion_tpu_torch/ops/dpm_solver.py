"""DPM-Solver and DPM-Solver++ sampling for a discrete-time VP diffusion
(mirrors the JAX package's ops/dpm_solver.py:35-572).

- methods "singlestep" (orders 1-3), "singlestep_fixed", "multistep"
  (orders 1-3, lower orders to warm up, `lower_order_final`) and
  "adaptive" (orders 2-3, step-size control);
- algorithm_type "dpmsolver++" (data prediction) and "dpmsolver" (noise
  prediction); solver_type "dpmsolver" and "taylor" in every order-2 and
  order-3 update;
- skip_type "time_uniform", "logSNR" and "time_quadratic";
- model types "eps" ("noise"), "x0" ("x_start") and "v";
- `correcting_x0_fn`, `correcting_xt_fn`, `denoise_to_zero`,
  `return_intermediate`, `t_start` / `t_end`, and classifier-free
  guidance (`guidance_scale`, `uncond_model_fn`).

Every method but "adaptive" computes its time grid, the per-step
alphas, sigmas and log-SNRs and every coefficient as float64 Python
scalars on the host, so the device runs only the model calls and the
linear combinations, and the chain has no host sync. "adaptive" decides
each step from the data: its times and coefficients are 0-d tensors in
x's dtype on x's device (`TracedVPSchedule`, the JAX package's
`jnp.interp` schedule), and each accept or reject costs one host read.
"""

import math

import numpy as np
import torch

# What `sample_denoiser` computes on its default path, named: a `sample`
# artifact records it and `serving.load_artifact` refuses one recorded
# with another name. Change it whenever a change here would move a
# sample's output.
SAMPLER = "dpmsolver++-singlestep-order3-time_uniform-v1"

ALGORITHMS = ("dpmsolver", "dpmsolver++")
SOLVERS = ("dpmsolver", "taylor")
METHODS = ("singlestep", "singlestep_fixed", "multistep", "adaptive")
SKIP_TYPES = ("time_uniform", "logSNR", "time_quadratic")


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


def interp(x, xp, fp):
    """`jnp.interp` in torch: piecewise-linear, held at fp[0] and fp[-1]
    outside [xp[0], xp[-1]]; xp increasing, all in one dtype."""
    i = torch.searchsorted(xp, x.reshape(-1), right=True).clamp(
        1, len(xp) - 1).reshape(x.shape)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    tiny = dx.abs() <= float(np.spacing(np.finfo(
        str(xp.dtype).removeprefix("torch.")).eps))
    f = torch.where(tiny, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(tiny, 1, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


class TracedVPSchedule:
    """`VPSchedule` on 0-d tensors of `dtype` on `device`, for the
    adaptive method: the same knots, rounded to `dtype` as the JAX
    package's `TracedVPSchedule` holds them, interpolated on the device."""

    def __init__(self, ns, dtype, device):
        self.N, self.T = ns.N, ns.T

        def put(a):
            return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                                device=device)

        self.t_array = put(ns.t_array)
        self.log_alpha_array = put(ns.log_alpha_array)
        self._log_alpha_rev = put(ns.log_alpha_array[::-1])
        self._t_rev = put(ns.t_array[::-1])

    def log_alpha(self, t):
        return interp(t, self.t_array, self.log_alpha_array)

    def alpha(self, t):
        return torch.exp(self.log_alpha(t))

    def sigma(self, t):
        return torch.sqrt(1.0 - torch.exp(2.0 * self.log_alpha(t)))

    def lam(self, t):
        la = self.log_alpha(t)
        return la - 0.5 * torch.log(1.0 - torch.exp(2.0 * la))

    def inverse_lambda(self, lam):
        log_alpha = -0.5 * torch.logaddexp(torch.zeros_like(lam), -2.0 * lam)
        return interp(log_alpha, self._log_alpha_rev, self._t_rev)


def _time_steps(ns, skip_type, t_T, t_0, N):
    """N + 1 times from t_T down to t_0, spaced by `skip_type`."""
    if skip_type == "time_uniform":
        return np.linspace(t_T, t_0, N + 1)
    if skip_type == "logSNR":
        lams = np.linspace(ns.lam(t_T), ns.lam(t_0), N + 1)
        return np.array([ns.inverse_lambda(float(lam)) for lam in lams])
    if skip_type == "time_quadratic":
        return np.linspace(t_T ** 0.5, t_0 ** 0.5, N + 1) ** 2
    raise ValueError(skip_type)


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
                      method="singlestep", skip_type="time_uniform",
                      model_type="eps", algorithm_type="dpmsolver++",
                      solver_type="dpmsolver", correcting_x0_fn=None,
                      correcting_xt_fn=None, guidance_scale=1.0,
                      uncond_model_fn=None, t_start=None, t_end=None,
                      lower_order_final=True, denoise_to_zero=False,
                      return_intermediate=False, atol=0.0078, rtol=0.05,
                      h_init=0.05, theta=0.9, t_err=1e-5):
    """x_0 from x_T by DPM-Solver(++).

    model_fn(x, t_continuous) -> model output of `model_type`; t is a
    Python float, or under "adaptive" a 0-d tensor of x's dtype.
    correcting_x0_fn is applied to every predicted x0 (data prediction
    only); correcting_xt_fn(x, t, step) to x after every step (not with
    "adaptive"). lower_order_final: "multistep" drops to lower orders in
    its last steps when steps < 10. denoise_to_zero: one last
    data-prediction step at t_0. return_intermediate: -> (x, [x after
    every step]). atol, rtol, h_init, theta and t_err steer "adaptive".
    """
    if algorithm_type not in ALGORITHMS:
        raise ValueError(algorithm_type)
    if solver_type not in SOLVERS:
        raise ValueError(solver_type)
    if method not in METHODS:
        raise ValueError(method)
    if skip_type not in SKIP_TYPES:
        raise ValueError(skip_type)
    if (return_intermediate or correcting_xt_fn is not None) and \
            method == "adaptive":
        raise ValueError("adaptive takes no return_intermediate or "
                         "correcting_xt_fn")
    ns = VPSchedule(betas)
    t_0 = 1.0 / ns.N if t_end is None else t_end
    t_T = ns.T if t_start is None else t_start

    def raw_fn(x, t):
        out = model_fn(x, t)
        if guidance_scale != 1.0:
            if uncond_model_fn is None:
                raise ValueError("guidance_scale != 1 needs uncond_model_fn")
            u = uncond_model_fn(x, t)
            out = u + guidance_scale * (out - u)
        return out

    def x0_fn(x, t, sched=ns):
        out = raw_fn(x, t)
        a, s = sched.alpha(t), sched.sigma(t)
        if model_type in ("eps", "noise"):
            x0 = (x - s * out) / a
        elif model_type == "v":
            x0 = a * x - s * out
        elif model_type in ("x0", "x_start"):
            x0 = out
        else:
            raise ValueError(model_type)
        if correcting_x0_fn is not None:
            x0 = correcting_x0_fn(x0)
        return x0

    def eps_fn(x, t, sched=ns):
        out = raw_fn(x, t)
        if model_type in ("eps", "noise"):
            return out
        a, s = sched.alpha(t), sched.sigma(t)
        if model_type in ("x0", "x_start"):
            return (x - a * out) / s
        if model_type == "v":
            return a * out + s * x
        raise ValueError(model_type)

    dpmpp = algorithm_type == "dpmsolver++"
    m_fn = x0_fn if dpmpp else eps_fn

    # The updates take `sched` (host floats or 0-d tensors) and `xp`, the
    # module whose exp / expm1 fit it (math or torch).

    def update_1(x, m_s, s, t, sched=ns, xp=math):
        h = sched.lam(t) - sched.lam(s)
        if dpmpp:
            return (sched.sigma(t) / sched.sigma(s)) * x \
                - (sched.alpha(t) * xp.expm1(-h)) * m_s
        return xp.exp(sched.log_alpha(t) - sched.log_alpha(s)) * x \
            - (sched.sigma(t) * xp.expm1(h)) * m_s

    def update_2(x, m_s, s, t, r1=0.5, sched=ns, xp=math):
        """-> (x_t, the model's value at the intermediate time)."""
        lam_s, lam_t = sched.lam(s), sched.lam(t)
        h = lam_t - lam_s
        s1 = sched.inverse_lambda(lam_s + r1 * h)
        if dpmpp:
            x_s1 = (sched.sigma(s1) / sched.sigma(s)) * x \
                - (sched.alpha(s1) * xp.expm1(-r1 * h)) * m_s
            m_s1 = m_fn(x_s1, s1, sched)
            phi_1 = xp.expm1(-h)
            base = (sched.sigma(t) / sched.sigma(s)) * x \
                - (sched.alpha(t) * phi_1) * m_s
            if solver_type == "dpmsolver":
                return base - (0.5 / r1) * (sched.alpha(t) * phi_1) * \
                    (m_s1 - m_s), m_s1
            return base + (1.0 / r1) * \
                (sched.alpha(t) * (phi_1 / h + 1.0)) * (m_s1 - m_s), m_s1
        la_s, la_s1, la_t = (sched.log_alpha(s), sched.log_alpha(s1),
                             sched.log_alpha(t))
        x_s1 = xp.exp(la_s1 - la_s) * x \
            - (sched.sigma(s1) * xp.expm1(r1 * h)) * m_s
        m_s1 = m_fn(x_s1, s1, sched)
        phi_1 = xp.expm1(h)
        base = xp.exp(la_t - la_s) * x - (sched.sigma(t) * phi_1) * m_s
        if solver_type == "dpmsolver":
            return base - (0.5 / r1) * (sched.sigma(t) * phi_1) * \
                (m_s1 - m_s), m_s1
        return base - (1.0 / r1) * \
            (sched.sigma(t) * (phi_1 / h - 1.0)) * (m_s1 - m_s), m_s1

    def update_3(x, m_s, s, t, r1=1.0 / 3.0, r2=2.0 / 3.0, m_s1=None,
                 sched=ns, xp=math):
        """`m_s1` may come in (adaptive re-uses its order-2 value)."""
        lam_s, lam_t = sched.lam(s), sched.lam(t)
        h = lam_t - lam_s
        s1 = sched.inverse_lambda(lam_s + r1 * h)
        s2 = sched.inverse_lambda(lam_s + r2 * h)
        if dpmpp:
            phi_11 = xp.expm1(-r1 * h)
            phi_12 = xp.expm1(-r2 * h)
            phi_1 = xp.expm1(-h)
            phi_22 = xp.expm1(-r2 * h) / (r2 * h) + 1.0
            phi_2 = phi_1 / h + 1.0
            if m_s1 is None:
                x_s1 = (sched.sigma(s1) / sched.sigma(s)) * x \
                    - (sched.alpha(s1) * phi_11) * m_s
                m_s1 = m_fn(x_s1, s1, sched)
            x_s2 = (sched.sigma(s2) / sched.sigma(s)) * x \
                - (sched.alpha(s2) * phi_12) * m_s \
                + (r2 / r1) * (sched.alpha(s2) * phi_22) * (m_s1 - m_s)
            m_s2 = m_fn(x_s2, s2, sched)
            base = (sched.sigma(t) / sched.sigma(s)) * x \
                - (sched.alpha(t) * phi_1) * m_s
            if solver_type == "dpmsolver":
                return base + (1.0 / r2) * (sched.alpha(t) * phi_2) * \
                    (m_s2 - m_s)
            phi_3 = phi_2 / h - 0.5
            d1_0 = (1.0 / r1) * (m_s1 - m_s)
            d1_1 = (1.0 / r2) * (m_s2 - m_s)
            d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
            d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
            return base + (sched.alpha(t) * phi_2) * d1 \
                - (sched.alpha(t) * phi_3) * d2
        la_s, la_s1, la_s2, la_t = (sched.log_alpha(s), sched.log_alpha(s1),
                                    sched.log_alpha(s2), sched.log_alpha(t))
        phi_11 = xp.expm1(r1 * h)
        phi_12 = xp.expm1(r2 * h)
        phi_1 = xp.expm1(h)
        phi_22 = xp.expm1(r2 * h) / (r2 * h) - 1.0
        phi_2 = phi_1 / h - 1.0
        if m_s1 is None:
            x_s1 = xp.exp(la_s1 - la_s) * x \
                - (sched.sigma(s1) * phi_11) * m_s
            m_s1 = m_fn(x_s1, s1, sched)
        x_s2 = xp.exp(la_s2 - la_s) * x \
            - (sched.sigma(s2) * phi_12) * m_s \
            - (r2 / r1) * (sched.sigma(s2) * phi_22) * (m_s1 - m_s)
        m_s2 = m_fn(x_s2, s2, sched)
        base = xp.exp(la_t - la_s) * x - (sched.sigma(t) * phi_1) * m_s
        if solver_type == "dpmsolver":
            return base - (1.0 / r2) * (sched.sigma(t) * phi_2) * \
                (m_s2 - m_s)
        phi_3 = phi_2 / h - 0.5
        d1_0 = (1.0 / r1) * (m_s1 - m_s)
        d1_1 = (1.0 / r2) * (m_s2 - m_s)
        d1 = (r2 * d1_0 - r1 * d1_1) / (r2 - r1)
        d2 = 2.0 * (d1_1 - d1_0) / (r2 - r1)
        return base - (sched.sigma(t) * phi_2) * d1 \
            - (sched.sigma(t) * phi_3) * d2

    def multistep_2(x, m_prev, t_prev, t):
        m1, m0 = m_prev[-2], m_prev[-1]
        t1, t0 = t_prev[-2], t_prev[-1]
        lam1, lam0, lam_t = ns.lam(t1), ns.lam(t0), ns.lam(t)
        h0, h = lam0 - lam1, lam_t - lam0
        r0 = h0 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        if dpmpp:
            phi_1 = math.expm1(-h)
            base = (ns.sigma(t) / ns.sigma(t0)) * x \
                - (ns.alpha(t) * phi_1) * m0
            if solver_type == "dpmsolver":
                return base - 0.5 * (ns.alpha(t) * phi_1) * d1_0
            return base + (ns.alpha(t) * (phi_1 / h + 1.0)) * d1_0
        phi_1 = math.expm1(h)
        base = math.exp(ns.log_alpha(t) - ns.log_alpha(t0)) * x \
            - (ns.sigma(t) * phi_1) * m0
        if solver_type == "dpmsolver":
            return base - 0.5 * (ns.sigma(t) * phi_1) * d1_0
        return base - (ns.sigma(t) * (phi_1 / h - 1.0)) * d1_0

    def multistep_3(x, m_prev, t_prev, t):
        m2, m1, m0 = m_prev[-3], m_prev[-2], m_prev[-1]
        t2, t1, t0 = t_prev[-3], t_prev[-2], t_prev[-1]
        lam2, lam1, lam0, lam_t = (ns.lam(t2), ns.lam(t1), ns.lam(t0),
                                   ns.lam(t))
        h1, h0, h = lam1 - lam2, lam0 - lam1, lam_t - lam0
        r0, r1 = h0 / h, h1 / h
        d1_0 = (1.0 / r0) * (m0 - m1)
        d1_1 = (1.0 / r1) * (m1 - m2)
        d1 = d1_0 + (r0 / (r0 + r1)) * (d1_0 - d1_1)
        d2 = (1.0 / (r0 + r1)) * (d1_0 - d1_1)
        if dpmpp:
            phi_1 = math.expm1(-h)
            phi_2 = phi_1 / h + 1.0
            phi_3 = phi_2 / h - 0.5
            return (ns.sigma(t) / ns.sigma(t0)) * x \
                - (ns.alpha(t) * phi_1) * m0 \
                + (ns.alpha(t) * phi_2) * d1 \
                - (ns.alpha(t) * phi_3) * d2
        phi_1 = math.expm1(h)
        phi_2 = phi_1 / h - 1.0
        phi_3 = phi_2 / h - 0.5
        return math.exp(ns.log_alpha(t) - ns.log_alpha(t0)) * x \
            - (ns.sigma(t) * phi_1) * m0 \
            - (ns.sigma(t) * phi_2) * d1 \
            - (ns.sigma(t) * phi_3) * d2

    def multistep_update(x, m_prev, t_prev, t, step_order):
        if step_order == 1:
            return update_1(x, m_prev[-1], t_prev[-1], t)
        if step_order == 2:
            return multistep_2(x, m_prev, t_prev, t)
        return multistep_3(x, m_prev, t_prev, t)

    x = x_T
    intermediates = []
    last_step = -1  # the step index denoise_to_zero's correction follows

    def post(x, t, step):
        nonlocal last_step
        last_step = step
        if correcting_xt_fn is not None:
            x = correcting_xt_fn(x, t, step)
        if return_intermediate:
            intermediates.append(x)
        return x

    if method in ("singlestep", "singlestep_fixed"):
        if method == "singlestep":
            orders = _singlestep_orders(steps, order)
            if skip_type == "logSNR":
                t_outer = _time_steps(ns, skip_type, t_T, t_0, len(orders))
            else:
                full = _time_steps(ns, skip_type, t_T, t_0, steps)
                t_outer = full[np.cumsum([0] + orders)]
        else:
            orders = [order] * (steps // order)
            t_outer = _time_steps(ns, skip_type, t_T, t_0, len(orders))
        for i, ord_i in enumerate(orders):
            s, t = float(t_outer[i]), float(t_outer[i + 1])
            # r1/r2 from the log-SNRs of an inner grid of the same
            # skip_type
            lam_s = ns.lam(s)
            h = ns.lam(t) - lam_s
            inner = [float(u) for u in _time_steps(ns, skip_type, s, t,
                                                   ord_i)]
            m_s = m_fn(x, s)
            if ord_i == 1:
                x = update_1(x, m_s, s, t)
            elif ord_i == 2:
                x, _ = update_2(x, m_s, s, t,
                                r1=(ns.lam(inner[1]) - lam_s) / h)
            else:
                x = update_3(x, m_s, s, t,
                             r1=(ns.lam(inner[1]) - lam_s) / h,
                             r2=(ns.lam(inner[2]) - lam_s) / h)
            x = post(x, t, i)
    elif method == "multistep":
        # warm up through orders 1..order-1; the model is never evaluated
        # at the final time
        if steps < order:
            raise ValueError(f"multistep needs steps >= order ({steps} < "
                             f"{order})")
        t_grid = [float(u) for u in _time_steps(ns, skip_type, t_T, t_0,
                                                steps)]
        t_prev = [t_grid[0]]
        m_prev = [m_fn(x, t_grid[0])]
        x = post(x, t_grid[0], 0)
        for step in range(1, order):
            t = t_grid[step]
            x = post(multistep_update(x, m_prev, t_prev, t, step), t, step)
            t_prev.append(t)
            m_prev.append(m_fn(x, t))
        for step in range(order, steps + 1):
            t = t_grid[step]
            step_order = min(order, steps + 1 - step) \
                if lower_order_final and steps < 10 else order
            x = post(multistep_update(x, m_prev, t_prev, t, step_order), t,
                     step)
            t_prev = t_prev[1:] + [t]
            if step < steps:
                m_prev = m_prev[1:] + [m_fn(x, t)]
    else:
        x = _adaptive(x, ns, t_T, t_0, order, m_fn, update_1, update_2,
                      update_3, atol, rtol, h_init, theta, t_err)

    if denoise_to_zero:
        x = x0_fn(x, t_0)
        if method != "adaptive":
            x = post(x, t_0, last_step + 1)
    if return_intermediate:
        return x, intermediates
    return x


def _adaptive(x, ns, t_T, t_0, order, m_fn, update_1, update_2, update_3,
              atol, rtol, h_init, theta, t_err):
    """The adaptive method: an order-1 / order-2 (order 2) or order-2 /
    order-3 (order 3) pair from s to the time `h` further in log-SNR; the
    higher is accepted when the scaled error E <= 1, and h scales by
    theta * E^(-1/order), capped at the distance left. Times, h and every
    coefficient are 0-d tensors in x's dtype; the loop condition is the
    one host read a step."""
    if order not in (2, 3):
        raise ValueError(f"adaptive takes order 2 or 3, not {order}")
    sched = TracedVPSchedule(ns, x.dtype, x.device)
    kw = dict(sched=sched, xp=torch)
    if order == 2:
        def lower(x, s, t):
            m_s = m_fn(x, s, sched)
            return update_1(x, m_s, s, t, **kw), (m_s,)

        def higher(x, s, t, aux):
            return update_2(x, aux[0], s, t, r1=0.5, **kw)[0]
    else:
        def lower(x, s, t):
            m_s = m_fn(x, s, sched)
            x_t, m_s1 = update_2(x, m_s, s, t, r1=1.0 / 3.0, **kw)
            return x_t, (m_s, m_s1)

        def higher(x, s, t, aux):
            return update_3(x, aux[0], s, t, r1=1.0 / 3.0, r2=2.0 / 3.0,
                            m_s1=aux[1], **kw)

    def scalar(v):
        return torch.tensor(v, dtype=x.dtype, device=x.device)

    lam_0 = sched.lam(scalar(t_0))
    s = scalar(t_T)
    lam_s, h = sched.lam(s), scalar(h_init)
    x_prev = x
    while bool((s - t_0).abs() > t_err):
        t = sched.inverse_lambda(lam_s + h)
        x_lower, aux = lower(x, s, t)
        x_higher = higher(x, s, t, aux)
        delta = torch.clamp(rtol * torch.maximum(x_lower.abs(),
                                                 x_prev.abs()), min=atol)
        err = ((x_higher - x_lower) / delta).reshape(x.shape[0], -1)
        E = err.square().mean(-1).sqrt().max()
        accept = E <= 1.0
        x = torch.where(accept, x_higher, x)
        x_prev = torch.where(accept, x_lower, x_prev)
        s = torch.where(accept, t, s)
        lam_s = torch.where(accept, sched.lam(t), lam_s)
        # the error power rounds through f32, as the JAX package's does
        ep = (E ** (-1.0 / order)).float().to(h.dtype)
        h = torch.minimum(theta * h * ep, lam_0 - lam_s)
    return x


def sample_denoiser(denoise, betas, x_T, cond, steps=20, order=3,
                    model_type="eps", correcting_x0_fn=None, **options):
    """`dpm_solver_sample` over a conditional denoiser in model time:
    `denoise(x, t [B], cond)` is called at t = (t_continuous - 1/N) * 1000
    for a schedule of N = len(betas) steps (`CondDDPM.sample_dpm`'s
    conversion, at any N). A host time is filled on x's device as a
    float, so no step waits on the device; adaptive's 0-d times stay
    there. `options` go to `dpm_solver_sample` (method, skip_type, ...)."""
    n = len(betas)

    def model_fn(x, t_cont):
        if isinstance(t_cont, torch.Tensor):
            t = ((t_cont - 1.0 / n) * 1000.0).float().expand(x.shape[0])
        else:
            t = torch.full((x.shape[0],), (t_cont - 1.0 / n) * 1000.0,
                           dtype=torch.float32, device=x.device)
        return denoise(x, t, cond)

    return dpm_solver_sample(model_fn, betas, x_T, steps=steps, order=order,
                             model_type=model_type,
                             correcting_x0_fn=correcting_x0_fn, **options)
