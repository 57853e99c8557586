"""Diffusion decoders (mirrors the JAX package's models/diffusion.py):
`CondDDPM` in pixel space with None, "concat" or "crossattn"
conditioning, the unconditional `DDPM`, and the `LDM` over a frozen
VQ-VAE. Each has `denoise`, `q_sample`, the training `loss_function` and
three samplers, which `generate_imgs` picks as the JAX package does
(DPM-Solver > DDIM > ancestral):

- `sample_ancestral`: all T steps of the posterior chain, fresh noise at
  each;
- `sample_ddim`: a subset of the timesteps, eta-parameterized;
- `sample_dpm`: DPM-Solver(++) (`ops/dpm_solver.py`), every method.

The x0 correction follows the space: in pixels a clamp to [-1, 1] in
ancestral and DDIM sampling and Imagen dynamic thresholding in DPM; the
LDM quantizes (quantize-as-denoise) in all three. Every draw comes from
an explicit `torch.Generator`, or from the `x_T` and per-step `noise`
the caller passes (the tests feed both packages the same draws).

Latents and images are NHWC at every public method, as in the JAX package.
Under a bf16 `compute_dtype` the UNet and the VQ-VAE compute in bf16 while
latents, images, the noise, the sampler's state and coefficients and the
loss stay f32 (the JAX models/diffusion.py:210).
"""

import numpy as np
import torch
from torch import nn

from ..ops.dpm_solver import sample_denoiser
from .schedules import (make_beta_schedule, make_ddim_sampling_parameters,
                        make_ddim_timesteps, make_gaussian_schedule)
from .unet import UNetModel
from .vqvae import VQVAEWrapper

CONDITIONING = (None, "concat", "crossattn")


def noise_like(generator, shape, same_noise, device):
    """Gaussian noise of `shape` from `generator`; `same_noise` draws one
    sample and repeats it over the batch (temporally consistent video)."""
    if generator is None:
        raise ValueError("sampling needs a torch.Generator or the draws")
    n = torch.randn((1, *shape[1:]) if same_noise else shape,
                    generator=generator, device=generator.device)
    return n.to(device).expand(shape).contiguous()


def dynamic_thresholding(x0, ratio=0.995, max_val=1.0):
    """Imagen dynamic thresholding: per sample, s = the `ratio` quantile
    of |x0| (at least `max_val`); clamp to [-s, s], scale to [-1, 1]."""
    s = torch.quantile(x0.abs().reshape(x0.shape[0], -1), ratio, dim=1)
    s = s.clamp(min=max_val).reshape(-1, *[1] * (x0.dim() - 1))
    return torch.clamp(x0, -s, s) / s


def denoise_nhwc(unet, x, t, context, generator=None):
    """The UNet on NHWC x: `CondDDPM.denoise` through the `unet` alone
    (the serving surface `denoise` holds nothing else)."""
    out = unet(x.permute(0, 3, 1, 2).contiguous(), t, context, generator)
    return out.permute(0, 2, 3, 1)


class CondDDPM(nn.Module):
    def __init__(self, resolution, unet_dict, diffusion_dict,
                 conditioning_key="crossattn", compute_dtype=torch.float32):
        super().__init__()
        if conditioning_key not in CONDITIONING:
            raise ValueError(f"conditioning {conditioning_key!r}")
        self.conditioning_key = conditioning_key
        d = dict(diffusion_dict)
        self.pred_target = d.get("pred_target", "eps")
        if self.pred_target not in ("eps", "x0", "v"):
            raise ValueError(f"pred_target {self.pred_target!r}")
        self.log_every_t = d.get("log_every_t", 200)
        kw = dict(schedule=d.get("beta_schedule", "linear"),
                  timesteps=d.get("timesteps", 1000),
                  linear_start=d.get("linear_start", 1e-4),
                  linear_end=d.get("linear_end", 2e-2),
                  cosine_s=d.get("cosine_s", 8e-3))
        # DPM-Solver's schedule, float64; the tables below are f32
        self.betas = make_beta_schedule(kw["schedule"], kw["timesteps"],
                                        kw["linear_start"],
                                        kw["linear_end"], kw["cosine_s"])
        self.schedule = make_gaussian_schedule(**kw)
        self.num_timesteps = len(self.betas)
        for name, table in self.schedule._asdict().items():
            if name != "betas":
                self.register_buffer(name, torch.from_numpy(table),
                                     persistent=False)
        self.resolution = tuple(resolution)
        ud = dict(unet_dict)
        # the sampled channels; under "concat" the UNet's input holds the
        # context's channels too
        self.channels = ud["out_channels"] if conditioning_key == "concat" \
            else ud.get("in_channels", 3)
        self.unet = UNetModel(
            in_channels=ud.get("in_channels", 3),
            model_channels=ud["model_channels"],
            out_channels=ud["out_channels"],
            num_res_blocks=ud["num_res_blocks"],
            attention_resolutions=tuple(ud["attention_resolutions"]),
            dropout=ud.get("dropout", 0.0),
            channel_mult=tuple(ud.get("channel_mult", (1, 2, 4, 8))),
            conv_resample=ud.get("conv_resample", True),
            use_checkpoint=ud.get("use_checkpoint", False),
            num_head_channels=ud.get("num_head_channels", 32),
            resblock_updown=ud.get("resblock_updown", False),
            transformer_depth=ud.get("transformer_depth", 1),
            context_dim=None if conditioning_key == "concat"
            else ud.get("context_dim"),
            attn_backend=ud.get("attn_backend", "einsum"),
            attn_softmax=ud.get("attn_softmax", "fast"),
            fused_gn=ud.get("fused_gn", False),
            conv_out_compute=ud.get("conv_out_compute", "f32"),
            compute_dtype=compute_dtype)

    @property
    def device(self):
        return self.unet.out[2].weight.device

    def denoise(self, x, t, context=None, generator=None):
        """x [B, H, W, C] NHWC, t [B], context (slots [B, S, D] under
        "crossattn", a map [B, H, W, C'] under "concat", None
        unconditioned) -> NHWC output. `generator` draws the UNet's
        dropout masks in train mode."""
        if self.conditioning_key is None:
            return denoise_nhwc(self.unet, x, t, None, generator)
        if context is None:
            raise ValueError("conditioning data required")
        if self.conditioning_key == "concat":
            return denoise_nhwc(self.unet, torch.cat([x, context], -1), t,
                                None, generator)
        return denoise_nhwc(self.unet, x, t, context, generator)

    forward = denoise

    @staticmethod
    def _extract(table, t, ndim):
        return table[t].reshape(-1, *[1] * (ndim - 1))

    def q_sample(self, x0, t, noise):
        """x_t ~ q(x_t | x_0) for integer timesteps t [B]."""
        return (self._extract(self.sqrt_alphas_bar, t, x0.dim()) * x0 +
                self._extract(self.sqrt_one_minus_alphas_bar, t, x0.dim())
                * noise)

    def predict_x0_from_eps(self, x_t, t, eps):
        return (self._extract(self.sqrt_recip_alphas_bar, t, x_t.dim()) * x_t
                - self._extract(self.sqrt_recipm1_alphas_bar, t, x_t.dim())
                * eps)

    def q_posterior(self, x0, x_t, t):
        """-> (mean, clipped log-variance) of q(x_{t-1} | x_t, x_0)."""
        mean = (self._extract(self.posterior_mean_coef1, t, x_t.dim()) * x0
                + self._extract(self.posterior_mean_coef2, t, x_t.dim())
                * x_t)
        return mean, self._extract(self.posterior_log_variance_clipped, t,
                                   x_t.dim())

    def _pred_to_x0(self, pred, x, t):
        if self.pred_target == "eps":
            return self.predict_x0_from_eps(x, t, pred)
        if self.pred_target == "v":
            return (self._extract(self.sqrt_alphas_bar, t, x.dim()) * x -
                    self._extract(self.sqrt_one_minus_alphas_bar, t,
                                  x.dim()) * pred)
        return pred

    def loss_function(self, x0, context=None, generator=None, t=None,
                      noise=None):
        """The denoising loss on NHWC x0: t ~ U{0..T-1}, Gaussian noise
        (both from `generator` unless given), MSE in f32 against the eps /
        v / x0 target. Tests pass `t` and `noise` to feed both packages
        the same draws."""
        if generator is None and (t is None or noise is None):
            raise ValueError("loss_function draws t and noise from a "
                             "torch.Generator")
        if t is None:
            t = torch.randint(0, self.num_timesteps, (x0.shape[0],),
                              generator=generator, device=x0.device)
        if noise is None:
            noise = torch.randn(x0.shape, generator=generator,
                                device=x0.device, dtype=x0.dtype)
        pred = self.denoise(self.q_sample(x0, t, noise), t, context,
                            generator)
        if self.pred_target == "eps":
            gt = noise
        elif self.pred_target == "v":
            gt = (self._extract(self.sqrt_alphas_bar, t, x0.dim()) * noise -
                  self._extract(self.sqrt_one_minus_alphas_bar, t, x0.dim())
                  * x0)
        else:
            gt = x0
        return {"denoise_loss": ((pred.float() - gt.detach().float()) ** 2
                                 ).mean()}

    # ---- x0 corrections (the LDM quantizes in both) -------------------

    def correct_x0(self, x0):
        """Ancestral and DDIM sampling: clamp to [-1, 1]."""
        return x0.clamp(-1.0, 1.0)

    def dpm_correct_x0(self, x0):
        """DPM-Solver: dynamic thresholding, not a clamp."""
        return dynamic_thresholding(x0)

    # ---- samplers -------------------------------------------------------

    def _start(self, generator, cond, batch_size, same_noise, x_T):
        B = batch_size or (cond.shape[0] if cond is not None else 1)
        if x_T is None:
            x_T = noise_like(generator, (B, *self.resolution,
                                         self.channels), same_noise,
                             self.device)
        return B, x_T

    def sample_ancestral(self, generator=None, cond=None, batch_size=None,
                         same_noise=False, ret_intermed=False, x_T=None,
                         noise=None):
        """All T steps of the posterior chain, t = T-1 down to 0, with
        fresh noise at every step but the last: from `generator`, or
        `noise[i]` at step i (T entries, the last unused, as the JAX
        package masks it). ret_intermed -> (x, [1 + T / log_every_t, B,
        ...]: x_T, then x every log_every_t steps ending at t = 0)."""
        B, x = self._start(generator, cond, batch_size, same_noise, x_T)
        T = self.num_timesteps
        keep = set(((T - 1) - np.arange(0, T, self.log_every_t)).tolist())
        inter = [x]
        for i, t in enumerate(range(T - 1, -1, -1)):
            tb = torch.full((B,), t, dtype=torch.long, device=x.device)
            x0 = self.correct_x0(self._pred_to_x0(
                self.denoise(x, tb, cond), x, tb))
            mean, logvar = self.q_posterior(x0, x, tb)
            if t > 0:
                n = noise[i] if noise is not None else noise_like(
                    generator, x.shape, same_noise, x.device)
                x = mean + torch.exp(0.5 * logvar) * n
            else:
                x = mean
            if ret_intermed and i in keep:
                inter.append(x)
        return (x, torch.stack(inter)) if ret_intermed else x

    def sample_ddim(self, generator=None, cond=None, batch_size=None,
                    steps=200, eta=0.0, same_noise=False, ret_intermed=False,
                    x_T=None, noise=None):
        """DDIM over min(steps, T) timesteps (the +1 shift, clipped to
        T-1), latest first. eps comes from the uncorrected x0; with eta >
        0 each step adds sigma times fresh noise (from `generator`, or
        `noise[i]` at step i). Coefficients are f32 scalars, as the JAX
        tables are. ret_intermed -> (x, [x_T, then x after every len //
        5-th step])."""
        B, x = self._start(generator, cond, batch_size, same_noise, x_T)
        T = self.num_timesteps
        tsteps = np.clip(make_ddim_timesteps(min(steps, T), T), 0, T - 1)
        sigmas, alphas, alphas_prev = make_ddim_sampling_parameters(
            np.asarray(self.schedule.alphas_bar, np.float64), tsteps, eta)
        n_steps = len(tsteps)
        keep = set(range(0, n_steps, max(n_steps // 5, 1)))
        inter = [x]
        for i in range(n_steps):
            j = n_steps - 1 - i
            a_t, a_prev, sigma = alphas[j], alphas_prev[j], sigmas[j]
            tb = torch.full((B,), int(tsteps[j]), dtype=torch.long,
                            device=x.device)
            x0 = self._pred_to_x0(self.denoise(x, tb, cond), x, tb)
            eps = (x - float(np.sqrt(a_t)) * x0) / float(np.sqrt(1.0 - a_t))
            x0 = self.correct_x0(x0)
            dir_xt = float(np.sqrt(np.maximum(
                1.0 - a_prev - sigma ** 2, np.float32(0.0)))) * eps
            x = float(np.sqrt(a_prev)) * x0 + dir_xt
            if sigma > 0:
                n = noise[i] if noise is not None else noise_like(
                    generator, x.shape, same_noise, x.device)
                x = x + float(sigma) * n
            if ret_intermed and i in keep:
                inter.append(x)
        return (x, torch.stack(inter)) if ret_intermed else x

    @property
    def dpm_steps(self):
        """DPM-Solver steps of `generate_imgs`: max(20, T/50)."""
        return max(20, self.num_timesteps // 50)

    def sample_dpm(self, generator=None, cond=None, batch_size=None,
                   steps=None, order=3, same_noise=False, x_T=None,
                   **options):
        """DPM-Solver++ (singlestep, order 3, steps = max(20, T/50)) by
        default; `options` (method, skip_type, algorithm_type,
        solver_type, ...) go to `ops.dpm_solver.dpm_solver_sample`."""
        _, x_T = self._start(generator, cond, batch_size, same_noise, x_T)
        return sample_denoiser(
            self.denoise, self.betas, x_T, cond, steps=steps or
            self.dpm_steps, order=order, model_type=self.pred_target,
            correcting_x0_fn=self.dpm_correct_x0, **options)

    def generate_imgs(self, generator=None, cond=None, batch_size=None,
                      use_dpm=False, use_ddim=False, same_noise=False,
                      ret_intermed=False, x_T=None, noise=None, **options):
        """DPM-Solver (`use_dpm`) > DDIM (`use_ddim`, steps = max(200,
        T/5)) > ancestral over all T steps, as the JAX package picks.
        `options` are the chosen sampler's own keywords (`sample_dpm`'s,
        or DDIM's `steps` and `eta`); `noise` the per-step draws of DDIM
        and ancestral. DPM with ret_intermed -> (x, None)."""
        if use_dpm:
            if noise is not None:
                raise ValueError("DPM-Solver draws no per-step noise")
            x = self.sample_dpm(generator, cond=cond, batch_size=batch_size,
                                same_noise=same_noise, x_T=x_T, **options)
            return (x, None) if ret_intermed else x
        if use_ddim:
            options.setdefault("steps", max(200, self.num_timesteps // 5))
            return self.sample_ddim(
                generator, cond=cond, batch_size=batch_size,
                same_noise=same_noise, ret_intermed=ret_intermed, x_T=x_T,
                noise=noise, **options)
        if options:
            raise ValueError(f"ancestral sampling takes no {sorted(options)}")
        return self.sample_ancestral(
            generator, cond=cond, batch_size=batch_size,
            same_noise=same_noise, ret_intermed=ret_intermed, x_T=x_T,
            noise=noise)


class DDPM(CondDDPM):
    """Unconditional pixel-space diffusion."""

    def __init__(self, resolution, unet_dict, diffusion_dict,
                 compute_dtype=torch.float32):
        super().__init__(resolution, unet_dict, diffusion_dict, None,
                         compute_dtype)

    def loss_function(self, x0, context=None, generator=None, t=None,
                      noise=None):
        if context is not None:
            raise ValueError("an unconditional DDPM takes no context")
        return super().loss_function(x0, None, generator, t, noise)


class LDM(CondDDPM):
    """Latent diffusion over a frozen VQ-VAE (`vae`): quantize-as-denoise
    is the x0 correction of every sampler."""

    def __init__(self, resolution, unet_dict, diffusion_dict, vae_dict,
                 conditioning_key="crossattn", compute_dtype=torch.float32):
        super().__init__(resolution, unet_dict, diffusion_dict,
                         conditioning_key, compute_dtype)
        self.vae = VQVAEWrapper(vae_dict["enc_dec_dict"],
                                vae_dict["vq_dict"],
                                diffusion_dict.get("z_scale_factor", 1.0),
                                compute_dtype)

    def correct_x0(self, x0):
        return self.vae.quantize(x0)

    dpm_correct_x0 = correct_x0

    def encode_latent(self, img):
        return self.vae.encode(img)

    def loss_function(self, img, context=None, generator=None, t=None,
                      noise=None):
        """The latent loss of NHWC images: the frozen VQ-VAE encodes them
        without gradient, then `CondDDPM.loss_function`."""
        with torch.no_grad():
            x0 = self.encode_latent(img)
        return super().loss_function(x0, context, generator, t, noise)

    def decode_latent(self, z):
        return self.vae.decode(z)
