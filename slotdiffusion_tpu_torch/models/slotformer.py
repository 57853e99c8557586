"""SlotFormer: autoregressive slot dynamics for video prediction (mirrors
the JAX package's models/slotformer.py:32-355).

- `SlotRollouter`: `in_proj` -> a transformer encoder (pre- or
  post-norm, torch's layer names, a standard softmax) over the window of
  `history_len * N` slot tokens -> `out_proj` of the last N tokens, the
  next frame's slots. Each step applies `in_proj` and the position
  embedding to the whole window anew, with no mask, and slides the
  window by N. The temporal PE is repeated per slot (each time step N
  times in a row), the slots PE tiled over the frames; a sine PE counts
  its positions down (`sin_pos_enc`) and is a buffer outside the
  state_dict, a learnable one (`enc_t_pe`, `enc_slots_pe`) a parameter.
- `SlotFormer`: the rollout, the slot MSE with its temporal loss-decay
  weights (normalised to sum to the rollout length), the `vid_len`
  mask of short videos, the per-step `slot_recon_loss_1..6` at eval,
  and the optional `img_recon_loss` through a frozen spatial broadcast
  decoder (its outputs carry no gradient, as the JAX model stops it).
- `LDMSlotFormer`: the decoder is a frozen slot-conditioned LDM
  (`frozen_modules`; grafted by `training/checkpoint.py:graft_pretrained`
  from `dec_dict["dm_ckp_path"]`); training is the slot MSE alone,
  `decode` samples frames by DPM-Solver++ with one noise sample shared by
  the batch, then the VQ decode.

Slots are [B, T, N, C]. Everything computes in `compute_dtype` (bf16
under `use_bf16`), as the JAX modules do in their `dtype`; the rollout's
window stays in the input's dtype and the losses are taken in f32.
"""

import numpy as np
import torch
from torch import nn

from .blocks import Linear
from .diffusion import LDM
from .predictor import TransformerEncoder, TransformerEncoderLayer
from .sa import SpatialBroadcastDecoder
from .slot_diffusion import _build_dm_decoder


def sin_pos_enc(seq_len, d_model):
    """[1, seq_len, d_model] f32 sinusoid PE whose positions run
    seq_len-1 .. 0 (the JAX `sin_pos_enc`)."""
    inv_freq = 1.0 / (10000 ** (np.arange(0.0, d_model, 2.0) / d_model))
    pos = np.arange(seq_len - 1, -1, -1, dtype=np.float64)
    sinusoid = np.outer(pos, inv_freq)
    pe = np.concatenate([np.sin(sinusoid), np.cos(sinusoid)], axis=-1)
    return torch.from_numpy(pe[None].astype(np.float32))


class SlotRollouter(nn.Module):
    """past slots [B, history_len, N, C] -> the next `pred_len` frames'
    slots [B, pred_len, N, C]."""

    def __init__(self, num_slots, slot_size, history_len, t_pe="sin",
                 slots_pe="", d_model=128, num_layers=4, num_heads=8,
                 ffn_dim=512, norm_first=True, compute_dtype=torch.float32):
        super().__init__()
        dt = dict(compute_dtype=compute_dtype)
        self.num_slots = num_slots
        self.history_len = history_len
        self.compute_dtype = compute_dtype
        self.in_proj = Linear(slot_size, d_model, **dt)
        self.transformer_encoder = TransformerEncoder(
            [TransformerEncoderLayer(d_model, num_heads, ffn_dim, norm_first,
                                     compute_dtype)
             for _ in range(num_layers)])
        self.out_proj = Linear(d_model, slot_size, **dt)
        if t_pe == "learnable":
            self.enc_t_pe = nn.Parameter(torch.zeros(1, history_len,
                                                     d_model))
        elif t_pe and "sin" in t_pe:
            self.register_buffer("enc_t_pe", sin_pos_enc(
                history_len, d_model), persistent=False)
        else:
            raise ValueError(f"temporal PE {t_pe!r}: 'sin' or 'learnable'")
        if slots_pe and "sin" in slots_pe:
            self.register_buffer("enc_slots_pe", sin_pos_enc(
                num_slots, d_model), persistent=False)
        elif slots_pe == "learnable":
            self.enc_slots_pe = nn.Parameter(torch.zeros(1, num_slots,
                                                         d_model))
        else:
            self.enc_slots_pe = None

    def pos_enc(self):
        """[1, history_len * N, d_model] in the compute dtype: the
        temporal PE repeated per slot, plus the slots PE tiled over the
        frames, summed in f32."""
        pe = self.enc_t_pe.repeat_interleave(self.num_slots, dim=1)
        if self.enc_slots_pe is not None:
            pe = pe + self.enc_slots_pe.repeat(1, self.history_len, 1)
        return pe.to(self.compute_dtype)

    def step(self, window, pe):
        """window [B, T*N, C] -> the next frame's slots [B, N, C]."""
        x = self.in_proj(window) + pe
        for layer in self.transformer_encoder.layers:
            x = layer(x)
        return self.out_proj(x[:, -self.num_slots:])

    def forward(self, x, pred_len):
        if x.shape[1] != self.history_len:
            raise ValueError(f"wrong burn-in steps: {x.shape[1]} frames, "
                             f"the rollouter takes {self.history_len}")
        B, T, N, C = x.shape
        window = x.reshape(B, T * N, C)
        pe = self.pos_enc()
        preds = []
        for _ in range(pred_len):
            pred = self.step(window, pe)
            window = torch.cat([window[:, N:], pred.to(window.dtype)], dim=1)
            preds.append(pred)
        return torch.stack(preds, dim=1)


class SlotFormer(nn.Module):
    """Slot dynamics with an optional frozen spatial broadcast decoder
    (`dec_dict["dec_channels"]`), used by the image loss and `decode`."""

    use_ema = False
    ema_prefix = ""
    # what the trainer hands `compute_losses` from a batch
    batch_keys = ("slots", "vid_len", "img")

    def __init__(self, resolution, slot_dict, dec_dict, rollout_dict,
                 loss_dict, compute_dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        self.num_slots = slot_dict["num_slots"]
        self.slot_size = slot_dict["slot_size"]
        self.compute_dtype = compute_dtype
        rd = dict(rollout_dict)
        self.history_len = rd["history_len"]
        self.rollouter = SlotRollouter(
            num_slots=rd.get("num_slots", self.num_slots),
            slot_size=rd.get("slot_size", self.slot_size),
            history_len=rd["history_len"], t_pe=rd.get("t_pe", "sin"),
            slots_pe=rd.get("slots_pe", ""), d_model=rd.get("d_model", 128),
            num_layers=rd.get("num_layers", 4),
            num_heads=rd.get("num_heads", 8),
            ffn_dim=rd.get("ffn_dim", 512),
            norm_first=rd.get("norm_first", True),
            compute_dtype=compute_dtype)
        self.rollout_len = loss_dict["rollout_len"]
        self.use_img_recon_loss = loss_dict.get("use_img_recon_loss", False)
        self._build_decoder(dict(dec_dict or {}))

    def _build_decoder(self, dec_dict):
        self.decoder = None
        if dec_dict.get("dec_channels"):
            self.decoder = SpatialBroadcastDecoder(
                self.resolution, tuple(dec_dict["dec_channels"]),
                tuple(dec_dict["dec_resolution"]), dec_dict.get("dec_ks", 5),
                dec_dict.get("dec_norm", ""),
                compute_dtype=self.compute_dtype)

    @property
    def frozen_modules(self):
        """What the trainer freezes: the decoder."""
        return () if self.decoder is None else (self.decoder,)

    def decode(self, slots):
        """slots [B', N, C] -> (recon [B', H, W, 3], recons, masks) of the
        frozen decoder, without gradient."""
        with torch.no_grad():
            return self.decoder(slots)

    def _decoded(self, slots, **decode_kw):
        """slots [B', N, C] -> {"recon_combined", "recons", "masks"}."""
        return dict(zip(("recon_combined", "recons", "masks"),
                        self.decode(slots, **decode_kw)))

    def rollout(self, past_slots, pred_len, decode=False, with_gt=True,
                **decode_kw):
        """Unroll `pred_len` future slot sets from the last `history_len`
        of `past_slots`; with `decode`, the decoded frames (and, with the
        spatial broadcast decoder, each slot's RGB and mask) of the past
        and predicted slots (`with_gt`) or of the predicted ones alone,
        [B, T, ...], and those slots; `decode_kw` go to `decode`."""
        pred = self.rollouter(past_slots[:, -self.history_len:], pred_len)
        if not decode:
            return pred
        slots = torch.cat([past_slots, pred], dim=1) if with_gt else pred
        B, T = slots.shape[:2]
        out = self._decoded(
            slots.reshape(B * T, self.num_slots, self.slot_size),
            **decode_kw)
        out = {k: v.reshape(B, T, *v.shape[1:]) for k, v in out.items()}
        return dict(out, slots=slots)

    def forward(self, data_dict, train=True):
        slots = data_dict["slots"]
        if slots.shape[1] != self.history_len + self.rollout_len:
            raise ValueError(
                f"wrong SlotFormer training length: {slots.shape[1]} "
                f"frames, history {self.history_len} + rollout "
                f"{self.rollout_len}")
        past, gt = slots[:, :self.history_len], slots[:, self.history_len:]
        if self.use_img_recon_loss:
            out = self.rollout(past, self.rollout_len, decode=True,
                               with_gt=False)
            out["pred_slots"] = out.pop("slots")
            out["gt_slots"] = gt
            return out
        return {"pred_slots": self.rollout(past, self.rollout_len),
                "gt_slots": gt}

    def compute_losses(self, data_dict, generator=None, sched=None,
                       train=True):
        """The slot MSE, each predicted step weighted by
        `sched["loss_decay_factor"] ** step` normalised to sum to the
        rollout length, over the steps inside `vid_len` where the batch
        has it; at eval also each of the first 6 steps' plain MSE; with
        `use_img_recon_loss` the frames' MSE. -> (out, losses). Nothing
        here draws: `generator` is unused."""
        out = self(data_dict, train=train)
        gt = out["gt_slots"].float()
        per_elem = (out["pred_slots"].float() - gt) ** 2  # [B, rT, N, C]
        rT = gt.shape[1]
        losses = {}
        if not train:
            for step in range(min(6, rT)):
                losses[f"slot_recon_loss_{step + 1}"] = \
                    per_elem[:, step].mean()
        decay = 1.0
        if sched is not None and "loss_decay_factor" in sched:
            decay = sched["loss_decay_factor"]
        w = torch.as_tensor(decay, dtype=torch.float32) ** torch.arange(
            rT, dtype=torch.float32)
        w = (w / w.sum() * rT).to(per_elem.device)
        weighted = per_elem * w[None, :, None, None]
        vid_len = data_dict.get("vid_len")
        valid = None
        if vid_len is not None:
            steps = torch.arange(rT, device=per_elem.device)
            valid = ((steps[None] + self.history_len) <
                     vid_len.to(per_elem.device)[:, None]).float()
            vmask = valid[:, :, None, None]
            losses["slot_recon_loss"] = (weighted * vmask).sum() / torch.clamp(
                vmask.sum() * gt.shape[2] * gt.shape[3], min=1.0)
        else:
            losses["slot_recon_loss"] = weighted.mean()
        if self.use_img_recon_loss:
            gt_img = data_dict["img"][:, self.history_len:].float()
            img_loss = (out["recon_combined"].float() - gt_img) ** 2
            if valid is not None:
                vmask = valid[:, :, None, None, None]
                losses["img_recon_loss"] = (img_loss * vmask).sum() / \
                    torch.clamp(vmask.sum() * float(np.prod(
                        img_loss.shape[2:])), min=1.0)
            else:
                losses["img_recon_loss"] = img_loss.mean()
        return out, losses


class LDMSlotFormer(SlotFormer):
    """SlotFormer whose decoder is a frozen slot-conditioned LDM
    (`dm_decoder`, built from `dec_dict` as SAViDiffusion's)."""

    def _build_decoder(self, dec_dict):
        self.decoder = None
        self.dm_decoder = _build_dm_decoder(dec_dict, self.compute_dtype)

    @property
    def frozen_modules(self):
        """What the trainer freezes: the whole LDM."""
        return (self.dm_decoder,)

    def decode(self, slots, generator=None, use_dpm=True, same_noise=True,
               x_T=None, **options):
        """slots [B', N, C] -> frames [B', H, W, 3] of the frozen LDM,
        without gradient: `generate_imgs` (DPM-Solver++ by default, one
        noise sample shared by the batch, drawn from `generator`, a
        generator seeded 0 on the model's device when None, unless `x_T`
        is given; `options` are the sampler's), then the VQ decode."""
        if generator is None and x_T is None:
            generator = torch.Generator(device=slots.device).manual_seed(0)
        with torch.no_grad():
            samples = self.dm_decoder.generate_imgs(
                generator, cond=slots, use_dpm=use_dpm,
                same_noise=same_noise, x_T=x_T, **options)
            if isinstance(self.dm_decoder, LDM):
                samples = self.dm_decoder.decode_latent(samples)
        return samples

    def _decoded(self, slots, **decode_kw):
        return {"recon_combined": self.decode(slots, **decode_kw)}
