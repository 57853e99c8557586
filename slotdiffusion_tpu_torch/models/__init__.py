"""Modules of the port, NCHW inside; public functions keep the JAX
package's layouts (NHWC images, [B, T, H, W, 3] video)."""

import torch


def build_model(params, device="cuda"):
    """Instantiate the model named by `params.model` (SAViDiffusion is the
    only model of this slice) on `device`, in eval mode."""
    from .slot_diffusion import SAViDiffusion
    if params.model != "SAViDiffusion":
        raise ValueError(f"model {params.model!r} is not ported yet")
    model = SAViDiffusion(
        resolution=tuple(params.resolution), slot_dict=params.slot_dict,
        enc_dict=params.enc_dict, dec_dict=params.dec_dict,
        pred_dict=params.pred_dict)
    return model.to(device).eval()


@torch.no_grad()
def init_random_(model, generator):
    """Fill every parameter from `generator` (seeded by the caller): norm
    scales near 1, biases small, matrices and kernels ~ N(0, 1/fan_in).
    Zero-initialized output layers get random values too, so a random
    model exercises every layer."""
    for name, p in model.named_parameters():
        noise = torch.randn(p.shape, generator=generator,
                            dtype=torch.float32).to(p.device)
        if p.dim() == 1:
            is_scale = name.endswith("weight")
            p.copy_((1.0 if is_scale else 0.0) + 0.02 * noise)
        elif name.endswith("embedding.weight"):
            p.copy_(noise)
        else:
            fan_in = p[0].numel() if p.dim() > 1 else p.shape[-1]
            p.copy_(noise * fan_in ** -0.5)
    return model
