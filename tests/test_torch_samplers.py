"""Every sampler of the port's diffusion decoder against the JAX package,
on the CPU: DPM-Solver (each method, algorithm type, solver type, order,
skip type and model type, and its options) over a cheap analytic model;
the schedule tables and DDIM parameters bit for bit; ancestral, DDIM and
DPM-Solver through the tiny SAViDiffusion's LDM, its pixel-space sibling
and the "concat" / unconditional decoders, fed the same x_T and
per-step noises as the JAX side draws (its key chain rebuilt here with
`jax.random`); and the three repairs of the port's defaults."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slotdiffusion_tpu.models import diffusion as jdiff
from slotdiffusion_tpu.models import schedules as jsched
from slotdiffusion_tpu.ops import dpm_solver as jdpm
from slotdiffusion_tpu_torch import configs
from slotdiffusion_tpu_torch.convert import convert_diffusion_state_dict
from slotdiffusion_tpu_torch.models import diffusion as tdiff
from slotdiffusion_tpu_torch.models import schedules as tsched
from slotdiffusion_tpu_torch.ops import dpm_solver as tdpm
from torch_parity_helpers import (RES, SLOT_SIZE, SLOTS, T_FRAMES,
                                  build_pair, random_params, t2n, video)

# f32 on both sides with the same formulas, summed in another order
TOL = dict(rtol=1e-4, atol=1e-5)
T_STEPS = 20  # the decoders' timesteps, cut as tests/test_sampling.py does


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch CPU thread: the samplers' small ops gain nothing from
    more, and beside other test processes more threads only contend for
    the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---- DPM-Solver over an analytic model ---------------------------------

BETAS = tsched.make_beta_schedule("linear", 1000)
_r = np.random.RandomState(0)
MIX = (_r.randn(3, 3) / 3).astype(np.float32)
X_T = _r.randn(2, 4, 4, 3).astype(np.float32)
UNCOND = (_r.randn(3, 3) / 3).astype(np.float32)


def _model(xp, mix):
    """out = 0.5 x + 0.3 tanh(x M) + 0.1 t, in jnp or torch; t a float or
    a 0-d array (adaptive)."""
    m = jnp.asarray(mix) if xp is jnp else torch.from_numpy(mix)

    def fn(x, t):
        return 0.5 * x + 0.3 * xp.tanh(x @ m) + 0.1 * t
    return fn


def _both(calls=None, **kw):
    """dpm_solver_sample on both sides from X_T; `calls`: a list each
    side's model calls are counted into ([jax, torch])."""
    jfn, tfn = _model(jnp, MIX), _model(torch, MIX)
    if calls is not None:
        calls[:] = [0, 0]

        def count(_):
            calls[0] += 1

        def jcounted(x, t):
            jax.debug.callback(count, t)
            return _model(jnp, MIX)(x, t)

        def tcounted(x, t):
            calls[1] += 1
            return _model(torch, MIX)(x, t)
        jfn, tfn = jcounted, tcounted
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("guidance_scale", 1.0) != 1.0:
        jkw["uncond_model_fn"] = _model(jnp, UNCOND)
        tkw["uncond_model_fn"] = _model(torch, UNCOND)
    ref = jdpm.dpm_solver_sample(jfn, BETAS, jnp.asarray(X_T), **jkw)
    jax.effects_barrier()
    with torch.no_grad():
        got = tdpm.dpm_solver_sample(tfn, BETAS, torch.from_numpy(X_T),
                                     **tkw)
    return ref, got


def _close(got, ref):
    np.testing.assert_allclose(t2n(got), np.asarray(ref), **TOL)


METHOD_CASES = [(m, a, s, o)
                for m, orders in (("singlestep", (1, 2, 3)),
                                  ("singlestep_fixed", (1, 2, 3)),
                                  ("multistep", (1, 2, 3)),
                                  ("adaptive", (2, 3)))
                for a in tdpm.ALGORITHMS for s in tdpm.SOLVERS
                for o in orders]


@pytest.mark.parametrize("method,algorithm,solver,order", METHOD_CASES)
def test_dpm_method_matches_jax(method, algorithm, solver, order):
    """Each method x algorithm_type x solver_type x order, 12 steps (6
    for multistep, so `lower_order_final` bites). Adaptive makes the same
    number of model calls as the JAX package's."""
    calls = []
    ref, got = _both(calls if method == "adaptive" else None,
                     steps=6 if method == "multistep" else 12, order=order,
                     method=method, algorithm_type=algorithm,
                     solver_type=solver)
    _close(got, ref)
    if method == "adaptive":
        assert calls[0] == calls[1] > 0, calls


@pytest.mark.parametrize("skip_type", tdpm.SKIP_TYPES)
@pytest.mark.parametrize("model_type", ("eps", "x0", "v"))
def test_dpm_skip_and_model_type_match_jax(skip_type, model_type):
    """Each skip_type x model_type through singlestep (orders [3, 3, 2]:
    the inner grid takes the skip_type too), multistep and noise
    prediction."""
    for kw in (dict(method="singlestep", steps=8),
               dict(method="multistep", steps=8),
               dict(method="singlestep", steps=8, algorithm_type="dpmsolver",
                    solver_type="taylor")):
        ref, got = _both(skip_type=skip_type, model_type=model_type, **kw)
        _close(got, ref)


@pytest.mark.parametrize("method", ("singlestep", "singlestep_fixed",
                                    "multistep"))
def test_dpm_intermediates_and_xt_correction_match_jax(method):
    """return_intermediate, correcting_xt_fn (its t and step index at
    every step; denoise_to_zero's last gets the last step + 1, with or
    without intermediates) and denoise_to_zero."""
    for inter in (True, False):
        seen = ([], [])

        def corr(which, xp):
            def fn(x, t, step):
                seen[which].append((float(t), int(step)))
                return xp.clip(x, -3.0, 3.0) if xp is jnp \
                    else x.clamp(-3.0, 3.0)
            return fn
        kw = dict(method=method, steps=7, order=2, denoise_to_zero=True,
                  return_intermediate=inter)
        ref = jdpm.dpm_solver_sample(_model(jnp, MIX), BETAS,
                                     jnp.asarray(X_T),
                                     correcting_xt_fn=corr(0, jnp), **kw)
        with torch.no_grad():
            got = tdpm.dpm_solver_sample(_model(torch, MIX), BETAS,
                                         torch.from_numpy(X_T),
                                         correcting_xt_fn=corr(1, torch),
                                         **kw)
        assert [s for _, s in seen[1]] == [s for _, s in seen[0]]
        np.testing.assert_allclose([t for t, _ in seen[1]],
                                   [t for t, _ in seen[0]], rtol=1e-12)
        assert seen[1][-1][1] == seen[1][-2][1] + 1
        if inter:
            assert len(got[1]) == len(ref[1]) == len(seen[1])
            for g, r in zip(got[1], ref[1]):
                _close(g, r)
            got, ref = got[0], ref[0]
        _close(got, ref)


@pytest.mark.parametrize("kw", [
    dict(t_start=0.7, t_end=0.01),
    dict(t_start=0.9, method="multistep", skip_type="logSNR"),
    dict(guidance_scale=2.5),
    dict(guidance_scale=0.5, method="multistep", algorithm_type="dpmsolver"),
    dict(guidance_scale=2.5, method="adaptive"),
    dict(correcting_x0_fn="clip"),
    dict(denoise_to_zero=True, method="adaptive", order=2),
], ids=["t_start_end", "t_start_logsnr", "guidance", "guidance_eps",
        "guidance_adaptive", "x0_clip", "adaptive_denoise_to_zero"])
def test_dpm_options_match_jax(kw):
    kw = dict(kw)
    kw.setdefault("steps", 9)
    if kw.get("correcting_x0_fn") == "clip":
        # each side's own clip (JAX traces it, so no shared function)
        jfn = lambda x: jnp.clip(x, -1.5, 1.5)  # noqa: E731
        tfn = lambda x: x.clamp(-1.5, 1.5)  # noqa: E731
        kw.pop("correcting_x0_fn")
        ref = jdpm.dpm_solver_sample(_model(jnp, MIX), BETAS,
                                     jnp.asarray(X_T), correcting_x0_fn=jfn,
                                     **kw)
        with torch.no_grad():
            got = tdpm.dpm_solver_sample(_model(torch, MIX), BETAS,
                                         torch.from_numpy(X_T),
                                         correcting_x0_fn=tfn, **kw)
    else:
        ref, got = _both(**kw)
    _close(got, ref)


def test_interp_is_jnp_interp():
    """The adaptive method's interpolation: inside, on the knots and
    outside them at both ends; in f32 against jnp.interp, in f64 against
    np.interp."""
    xp = np.sort(np.random.RandomState(1).rand(50))
    fp = np.random.RandomState(2).randn(50)
    x = np.concatenate([np.linspace(-0.5, 1.5, 301), xp[::7]])
    f32 = [a.astype(np.float32) for a in (x, xp, fp)]
    np.testing.assert_allclose(
        t2n(tdpm.interp(*map(torch.from_numpy, f32))),
        np.asarray(jnp.interp(*map(jnp.asarray, f32))), rtol=1e-6,
        atol=1e-7)
    np.testing.assert_allclose(
        t2n(tdpm.interp(*map(torch.from_numpy, (x, xp, fp)))),
        np.interp(x, xp, fp), rtol=1e-13)


# ---- schedules ------------------------------------------------------------

@pytest.mark.parametrize("schedule", ("linear", "cosine", "sqrt_linear",
                                      "sqrt"))
def test_schedule_tables_equal_jax(schedule):
    kw = dict(linear_start=0.0015, linear_end=0.0195, cosine_s=0.01)
    np.testing.assert_array_equal(
        tsched.make_beta_schedule(schedule, 200, **kw),
        jsched.make_beta_schedule(schedule, 200, **kw))
    got = tsched.make_gaussian_schedule(schedule, 200, **kw)
    ref = jsched.make_gaussian_schedule(schedule, 200, **kw)
    assert got._fields == ref._fields
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype == np.float32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # the decoder keeps them as non-persistent buffers
    dm = tdiff.CondDDPM((8, 8), _unet_dict(), dict(
        beta_schedule=schedule, timesteps=200, **kw))
    assert not any(n in dm.state_dict() for n in ref._fields)
    for name in ref._fields[1:]:
        np.testing.assert_array_equal(t2n(getattr(dm, name)),
                                      getattr(ref, name))


@pytest.mark.parametrize("method", ("uniform", "quad"))
@pytest.mark.parametrize("eta", (0.0, 0.7))
def test_ddim_parameters_equal_jax(method, eta):
    alphas = np.asarray(jsched.make_gaussian_schedule().alphas_bar,
                        np.float64)
    for steps in (7, 50, 200):
        ts = tsched.make_ddim_timesteps(steps, 1000, method)
        np.testing.assert_array_equal(
            ts, jsched.make_ddim_timesteps(steps, 1000, method))
        for a, b in zip(tsched.make_ddim_sampling_parameters(alphas, ts, eta),
                        jsched.make_ddim_sampling_parameters(alphas, ts,
                                                             eta)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# ---- the decoders ------------------------------------------------------------

def _unet_dict(in_channels=3, context_dim=16):
    return dict(in_channels=in_channels, model_channels=16, out_channels=3,
                num_res_blocks=1, attention_resolutions=(1,), dropout=0.0,
                channel_mult=(1, 2), num_head_channels=8,
                context_dim=context_dim)


DIFF_DICT = dict(pred_target="eps", timesteps=T_STEPS,
                 beta_schedule="linear", linear_start=0.0015,
                 linear_end=0.0195, log_every_t=10)


def _tiny_cfg(use_pallas=True, pixel=False):
    cfg = configs.tiny_config(RES, SLOTS, SLOT_SIZE, T_STEPS, use_pallas)
    dec = dict(cfg.dec_dict, diffusion_dict=dict(
        cfg.dec_dict["diffusion_dict"], log_every_t=7))
    if pixel:
        dec.pop("vae_dict")
        dec["resolution"] = RES
    return cfg.copy(dec_dict=dec)


@pytest.fixture(scope="module")
def ldm_pair():
    return build_pair(cfg=_tiny_cfg())


@pytest.fixture(scope="module")
def pixel_pair():
    return build_pair(cfg=_tiny_cfg(pixel=True))


def _jit(pair, fn):
    _, jmodel, jvars, _ = pair
    return jax.jit(lambda v, *a: jmodel.apply(v, *a, method=fn))


def jax_draws(seed, shape, same_noise, steps):
    """The JAX package's draws in ancestral and DDIM sampling from
    PRNGKey(seed): x_T from the first split, then one key a step."""
    rng, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    x_T = jdiff.noise_like(init_rng, shape, same_noise)
    noises = []
    for _ in range(steps):
        rng, step_rng = jax.random.split(rng)
        noises.append(torch.from_numpy(np.array(
            jdiff.noise_like(step_rng, shape, same_noise))))
    return torch.from_numpy(np.array(x_T)), noises


def _cond(seed=3, B=2 * T_FRAMES):
    return np.random.RandomState(seed).randn(B, SLOTS, SLOT_SIZE).astype(
        np.float32)


def _codes_then_close(dm, got, ref, jquant=None):
    """The share of latent positions whose VQ code differs (reported,
    must be 0), then the values."""
    if jquant is not None:
        with torch.no_grad():
            q = t2n(dm.vae.quantize(got))
        flipped = np.any(q != np.asarray(jquant), axis=-1).mean()
        print(f"{flipped:.2%} of latent positions changed code")
        assert flipped == 0.0
    _close(got, ref)


@pytest.mark.parametrize("same_noise", (False, True))
@pytest.mark.parametrize("sampler", ("ancestral", "ddim"))
def test_generate_imgs_matches_jax(ldm_pair, sampler, same_noise):
    """`generate_imgs` ancestral (all 20 steps) and DDIM (eta 0, min(200,
    T) steps) from the JAX package's own draws, with and without
    ret_intermed (the JAX side's final x is the same either way)."""
    cond = _cond()
    use_ddim = sampler == "ddim"

    def jfn(m, c):
        x, inter = m.dm_decoder.generate_imgs(
            jax.random.PRNGKey(7), cond=c, use_ddim=use_ddim,
            same_noise=same_noise, ret_intermed=True)
        return x, inter, m.dm_decoder.vae.quantize(x)
    ref, ref_inter, jq = _jit(ldm_pair, jfn)(ldm_pair[2], jnp.asarray(cond))
    dm = ldm_pair[3].dm_decoder
    x_T, noises = jax_draws(7, (cond.shape[0], 4, 4, 3), same_noise, T_STEPS)
    with torch.no_grad():
        got, inter = dm.generate_imgs(
            cond=torch.from_numpy(cond), use_ddim=use_ddim,
            same_noise=same_noise, ret_intermed=True, x_T=x_T,
            noise=noises)
        plain = dm.generate_imgs(cond=torch.from_numpy(cond),
                                 use_ddim=use_ddim, same_noise=same_noise,
                                 x_T=x_T, noise=noises)
    assert torch.equal(plain, got)
    assert inter.shape == ref_inter.shape
    _codes_then_close(dm, got, ref, jq)
    _close(inter, ref_inter)


def test_ddim_eta_matches_jax(ldm_pair):
    """DDIM with eta 0.6 over 10 of the 20 steps (`generate_imgs` takes
    DDIM's own keywords; the JAX one has none, so its `sample_ddim`):
    sigma times the JAX draws at each step; intermediates every 2nd
    step."""
    cond = _cond(4)

    def jfn(m, c):
        x, inter = m.dm_decoder.sample_ddim(
            jax.random.PRNGKey(11), cond=c, steps=10, eta=0.6,
            ret_intermed=True)
        return x, inter, m.dm_decoder.vae.quantize(x)
    ref, ref_inter, jq = _jit(ldm_pair, jfn)(ldm_pair[2], jnp.asarray(cond))
    dm = ldm_pair[3].dm_decoder
    x_T, noises = jax_draws(11, (cond.shape[0], 4, 4, 3), False, 10)
    with torch.no_grad():
        got, inter = dm.generate_imgs(cond=torch.from_numpy(cond),
                                      use_ddim=True, steps=10, eta=0.6,
                                      ret_intermed=True, x_T=x_T,
                                      noise=noises)
    assert inter.shape[0] == ref_inter.shape[0] == 6
    _codes_then_close(dm, got, ref, jq)
    _close(inter, ref_inter)


def _jax_dpm(m, c, x, **kw):
    """The JAX decoder's DPM-Solver with any method: `sample_dpm`'s model
    function and correction, `dpm_solver_sample`'s options."""
    dm = m.dm_decoder
    n, B = dm.num_timesteps, x.shape[0]

    def model_fn(x, t):
        return dm.denoise(x, jnp.broadcast_to((t - 1.0 / n) * 1000.0, (B,)),
                          context=c)
    corr = jdiff._dynamic_thresholding if dm.clip_denoised \
        else dm._vq_correct
    return jdpm.dpm_solver_sample(
        model_fn, np.asarray(dm.schedule.betas, np.float64), x,
        model_type=dm.pred_target, correcting_x0_fn=corr, **kw)


@pytest.mark.parametrize("kw", [
    dict(method="multistep", steps=4, order=3),
    dict(method="adaptive", order=3),
    dict(method="singlestep_fixed", steps=4, order=2,
         algorithm_type="dpmsolver", solver_type="taylor",
         skip_type="logSNR"),
], ids=["multistep", "adaptive", "fixed_eps_taylor_logsnr"])
def test_generate_imgs_dpm_methods_match_jax(ldm_pair, kw):
    """DPM-Solver methods through the LDM's `generate_imgs(use_dpm=True)`
    with quantize-as-denoise, from the same x_T."""
    cond = _cond(5)
    x_T = np.random.RandomState(6).randn(cond.shape[0], 4, 4, 3).astype(
        np.float32)

    def jfn(m, c, x):
        z = _jax_dpm(m, c, x, **kw)
        return z, m.dm_decoder.vae.quantize(z)
    ref, jq = _jit(ldm_pair, jfn)(ldm_pair[2], jnp.asarray(cond),
                                  jnp.asarray(x_T))
    dm = ldm_pair[3].dm_decoder
    with torch.no_grad():
        got = dm.generate_imgs(cond=torch.from_numpy(cond), use_dpm=True,
                               x_T=torch.from_numpy(x_T), **kw)
    _codes_then_close(dm, got, ref, jq)


def test_log_images_ancestral_matches_jax():
    """`log_images(use_dpm=False)`: encode, the ancestral chain over the
    B*T frames from one shared noise (same_noise), VQ decode, against the
    JAX method. Slot attention in f32 on both sides (no bf16 k/v), so
    the slots agree to f32 rounding."""
    pair = build_pair(use_pallas=False, cfg=_tiny_cfg(use_pallas=False))
    img = video(8, B=2)

    def jfn(m, x):
        out = m.log_images({"img": x}, jax.random.PRNGKey(3),
                           use_dpm=False)
        flat = out["slots"].reshape(-1, SLOTS, SLOT_SIZE)
        z = m.dm_decoder.generate_imgs(jax.random.PRNGKey(3), cond=flat,
                                       same_noise=True)
        return out, m.dm_decoder.vae.quantize(z)
    ref, jq = _jit(pair, jfn)(pair[2], jnp.asarray(img))
    model = pair[3]
    latents = []
    decode = model.dm_decoder.decode_latent
    model.dm_decoder.decode_latent = lambda z: latents.append(z) or \
        decode(z)
    x_T, noises = jax_draws(3, (2 * T_FRAMES, 4, 4, 3), True, T_STEPS)
    try:
        with torch.no_grad():
            out = model.log_images({"img": torch.from_numpy(img)},
                                   use_dpm=False, x_T=x_T, noise=noises)
    finally:
        del model.dm_decoder.decode_latent
    with torch.no_grad():
        q = t2n(model.dm_decoder.vae.quantize(latents[0]))
    flipped = np.any(q != np.asarray(jq), axis=-1).mean()
    print(f"{flipped:.2%} of latent positions changed code")
    assert flipped == 0.0
    _close(out["slots"], ref["slots"])
    assert out["samples"].shape == (2, T_FRAMES, *RES, 3)
    _close(out["samples"], ref["samples"])


def test_pixel_space_dpm_thresholds_and_ancestral_clamps(pixel_pair):
    """The decoder without a `vae_dict` samples pixels: DPM-Solver++ with
    dynamic thresholding and the ancestral chain with the clamp, each
    against the JAX package; each correction changes the result (it
    bites), and `log_images` returns the pixels as they are."""
    cond = _cond(9)
    shape = (cond.shape[0], *RES, 3)
    x_T = np.random.RandomState(10).randn(*shape).astype(np.float32) * 2

    def jfn(m, c, x):
        dm = m.dm_decoder
        return (dm.sample_dpm(jax.random.PRNGKey(0), cond=c, steps=4,
                              x_T=x),
                dm.generate_imgs(jax.random.PRNGKey(4), cond=c))
    ref_dpm, ref_anc = _jit(pixel_pair, jfn)(
        pixel_pair[2], jnp.asarray(cond), jnp.asarray(x_T))
    dm = pixel_pair[3].dm_decoder
    assert type(dm) is tdiff.CondDDPM and not hasattr(dm, "vae")
    c = torch.from_numpy(cond)
    x0_draws, noises = jax_draws(4, shape, False, T_STEPS)
    with torch.no_grad():
        dpm = dm.sample_dpm(cond=c, steps=4, x_T=torch.from_numpy(x_T))
        anc = dm.generate_imgs(cond=c, x_T=x0_draws, noise=noises)
        dm.dpm_correct_x0 = dm.correct_x0 = lambda x: x
        try:
            raw_dpm = dm.sample_dpm(cond=c, steps=4,
                                    x_T=torch.from_numpy(x_T))
            raw_anc = dm.generate_imgs(cond=c, x_T=x0_draws, noise=noises)
        finally:
            del dm.dpm_correct_x0, dm.correct_x0
    _close(dpm, ref_dpm)
    _close(anc, ref_anc)
    assert (raw_dpm - dpm).abs().max() > 1e-2
    assert (raw_anc - anc).abs().max() > 1e-2
    with torch.no_grad():
        out = pixel_pair[3].log_images(
            {"img": torch.from_numpy(video(2, B=1))},
            torch.Generator().manual_seed(0), steps=3)
    assert out["samples"].shape == (1, T_FRAMES, *RES, 3)
    assert torch.isfinite(out["samples"]).all()


def test_dynamic_thresholding_matches_jax_at_flagship_frames():
    """torch.quantile takes 12 frames of 128x128x3 (its input-size cap
    is not reached) and gives jnp.quantile's linear interpolation."""
    x = np.random.RandomState(12).randn(12, 128, 128, 3).astype(
        np.float32) * 1.5
    x[:2] *= 0.2  # two samples whose quantile is below 1 (s = 1)
    ref = jdiff._dynamic_thresholding(jnp.asarray(x))
    got = tdiff.dynamic_thresholding(torch.from_numpy(x))
    np.testing.assert_allclose(t2n(got), np.asarray(ref), rtol=1e-6,
                               atol=1e-7)


def test_gn_kernel_refuses_pixel_groups_over_its_limit():
    """The GN kernel takes groups of any length: over MAX_GROUP values
    they take its two-pass path. The wrapper's checks take the shapes
    that once exceeded the single-read limit (the 384-channel norm at
    56x56 latents, 12 x 3,136 = 37,632 values a group; the pixel decoder
    at 64x64, 12 x 4,096; 128 channels at 128x128, 4 x 16,384) and still
    refuse what the kernel does not take: a dtype other than f32 and
    bf16, an activation other than SiLU, channels that do not split into
    the groups."""
    from slotdiffusion_tpu_torch.ops import fused_norm
    for B, C, side in ((8, 384, 56), (1, 384, 64), (1, 128, 128)):
        for dt in (torch.float32, torch.bfloat16):
            x, w = torch.zeros(B, C, side, side, dtype=dt), torch.ones(C)
            assert C // 32 * side * side > fused_norm.MAX_GROUP
            fused_norm.check_inputs(x, w, w, 32, "silu")
            fused_norm.check_inputs(x, w, w, 32, None)
        with pytest.raises(ValueError, match="f32 or bf16"):
            fused_norm.check_inputs(x.half(), w, w, 32, "silu")
        with pytest.raises(ValueError, match="act"):
            fused_norm.check_inputs(x, w, w, 32, "gelu")
        with pytest.raises(ValueError, match="groups"):
            fused_norm.check_inputs(x, w, w, 33, "silu")


def _bare_pair(jcls, tcls, conditioning, in_channels, context_dim):
    """A bare JAX decoder and the port's with its converted weights (the
    strict load)."""
    ud = _unet_dict(in_channels, context_dim)
    kw = dict(resolution=(8, 8), unet_dict=ud, diffusion_dict=DIFF_DICT)
    if jcls is jdiff.CondDDPM:
        kw["conditioning_key"] = conditioning
    jm = jcls(**kw)
    ctx = None if conditioning is None else (
        jnp.zeros((2, 8, 8, in_channels - 3)) if conditioning == "concat"
        else jnp.zeros((2, 4, context_dim)))
    shapes = jax.eval_shape(
        lambda r, x: jm.init(r, x, context=ctx, method=jm.loss_function),
        {"params": jax.random.PRNGKey(0),
         "diffusion": jax.random.PRNGKey(1)}, jnp.zeros((2, 8, 8, 3)))
    params = random_params(shapes["params"], seed=5)
    tm = tcls(**kw)
    missing, unexpected = tm.load_state_dict(
        convert_diffusion_state_dict(params, {"unet_dict": ud}),
        strict=True)
    assert not missing and not unexpected
    return jm, {"params": jax.tree_util.tree_map(jnp.asarray, params)}, tm


@pytest.mark.parametrize("conditioning", ("concat", None))
def test_concat_and_unconditional_decoders_match_jax(conditioning):
    """`denoise` of a "concat" CondDDPM (the context map joins x on the
    channels) and of the unconditional DDPM on converted weights, then
    the ancestral chain of each against the JAX package's draws."""
    if conditioning == "concat":
        jm, jv, tm = _bare_pair(jdiff.CondDDPM, tdiff.CondDDPM, "concat", 5,
                                None)
        ctx = np.random.RandomState(13).randn(2, 8, 8, 2).astype(np.float32)
    else:
        jm, jv, tm = _bare_pair(jdiff.DDPM, tdiff.DDPM, None, 3, None)
        ctx = None
    r = np.random.RandomState(14)
    x = r.randn(2, 8, 8, 3).astype(np.float32)
    t = np.array([3, 17], np.int32)
    jctx = None if ctx is None else jnp.asarray(ctx)
    tctx = None if ctx is None else torch.from_numpy(ctx)
    ref = jm.apply(jv, jnp.asarray(x), jnp.asarray(t), context=jctx,
                   method=jm.denoise)
    with torch.no_grad():
        got = tm.denoise(torch.from_numpy(x), torch.from_numpy(t), tctx)
    _close(got, ref)
    if conditioning == "concat":
        # the JAX package samples its in_channels (x and context): only
        # the port's chain runs, over the UNet's output channels
        with torch.no_grad():
            s = tm.generate_imgs(torch.Generator().manual_seed(0),
                                 cond=tctx)
        assert s.shape == (2, 8, 8, 3) and torch.isfinite(s).all()
        return
    ref = jax.jit(lambda v: jm.apply(
        v, jax.random.PRNGKey(2), batch_size=2, same_noise=True,
        method=jm.generate_imgs))(jv)
    x_T, noises = jax_draws(2, (2, 8, 8, 3), True, T_STEPS)
    with torch.no_grad():
        got = tm.generate_imgs(batch_size=2, same_noise=True, x_T=x_T,
                               noise=noises)
    _close(got, ref)


def test_bf16_sampler_state_stays_f32():
    """Under use_bf16 the UNet computes in bf16; x_T, the noise, the
    sampler's state and what it returns stay f32 in every sampler."""
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    cfg = _tiny_cfg().copy(use_bf16=True)
    dm = init_random_(build_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(0)).dm_decoder
    cond = torch.from_numpy(_cond(15)).to(torch.bfloat16)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for kw in (dict(), dict(use_ddim=True), dict(use_dpm=True),
                   dict(use_dpm=True, method="adaptive")):
            out = dm.generate_imgs(g, cond=cond, **kw)
            assert out.dtype == torch.float32, kw
            assert torch.isfinite(out).all(), kw
        _, inter = dm.generate_imgs(g, cond=cond, ret_intermed=True)
        assert inter.dtype == torch.float32


# ---- the repairs ---------------------------------------------------------------

def test_generate_imgs_takes_the_jax_signature_and_defaults(ldm_pair):
    """Repair: `generate_imgs` defaulted to DPM-Solver (use_dpm=True) and
    raised for anything else; the JAX default is the ancestral chain over
    all T steps."""
    want = inspect.signature(jdiff.CondDDPM.generate_imgs).parameters
    have = inspect.signature(tdiff.CondDDPM.generate_imgs).parameters
    for name in ("cond", "batch_size", "use_dpm", "use_ddim", "same_noise",
                 "ret_intermed", "x_T"):
        assert have[name].default == want[name].default, name
    dm = ldm_pair[3].dm_decoder
    calls = []
    unet = dm.unet.forward
    dm.unet.forward = lambda *a, **k: calls.append(1) or unet(*a, **k)
    try:
        with torch.no_grad():
            dm.generate_imgs(torch.Generator().manual_seed(0),
                             cond=torch.from_numpy(_cond(16)))
    finally:
        del dm.unet.forward
    assert len(calls) == T_STEPS


def test_log_images_passes_its_keywords_to_generate_imgs(ldm_pair):
    """Repair: `log_images` took a fixed set of keywords, so it could not
    ask for DDIM. Its own defaults stay DPM-Solver with shared noise."""
    sig = inspect.signature(ldm_pair[3].log_images).parameters
    assert sig["use_dpm"].default is True
    assert sig["same_noise"].default is True
    model, img = ldm_pair[3], torch.from_numpy(video(17, B=1))
    x_T = torch.randn(T_FRAMES, 4, 4, 3, generator=torch.Generator()
                      .manual_seed(2))
    with torch.no_grad():
        out = model.log_images({"img": img}, use_dpm=False, use_ddim=True,
                               x_T=x_T, steps=5)
        slots = model({"img": img})["slots"].reshape(-1, SLOTS, SLOT_SIZE)
        want = model.dm_decoder.decode_latent(model.dm_decoder.sample_ddim(
            cond=slots, steps=5, x_T=x_T))
    assert torch.equal(out["samples"].reshape(want.shape), want)


def test_load_lpips_defaults_to_the_card(tmp_path):
    """Repair: `load_lpips` ran on the CPU unless asked for the card; the
    port's entry points run on the card unless the caller asks for the
    CPU. A caller that passes a device keeps working."""
    from slotdiffusion_tpu_torch.ops import lpips
    assert inspect.signature(lpips.load_lpips).parameters[
        "device"].default == "cuda"
    npz = str(tmp_path / "lpips.npz")
    lpips.save_random_lpips_npz(npz)
    assert next(lpips.load_lpips(npz, "cpu").buffers()).device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            lpips.load_lpips(npz)
