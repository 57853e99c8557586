"""SAVi encoder side with the masked slot attention (mirrors
the JAX package's models/savi.py:29-160 with `return_mask=True`).

The frame loop is a Python loop: frame 0 runs slot attention directly
from `init_latents` (tiled over the batch); every later frame, and every
frame of a continued chunk (`prev_slots` given), runs predictor -> slot
attention on the previous frame's slots.
"""

import torch
from torch import nn

from .predictor import build_predictor
from .sa import SAEncoder
from .slot_attention import SlotAttention


class SAVi(nn.Module):
    def __init__(self, resolution, slot_dict, enc_dict, pred_dict, eps=1e-6,
                 compute_dtype=torch.float32):
        super().__init__()
        self.num_slots = slot_dict["num_slots"]
        self.slot_size = slot_dict["slot_size"]
        self.init_latents = nn.Parameter(
            torch.zeros(1, self.num_slots, self.slot_size))
        self.compute_dtype = compute_dtype
        self.encoder = SAEncoder(enc_dict, resolution, compute_dtype)
        self.slot_attention = SlotAttention(
            in_features=enc_dict["enc_out_channels"],
            num_iterations=slot_dict["num_iterations"],
            slot_size=self.slot_size,
            mlp_hidden_size=slot_dict["slot_mlp_size"], eps=eps,
            return_last_attn=True,
            use_pallas=slot_dict.get("use_pallas", "auto"),
            compute_dtype=compute_dtype)
        self.predictor = build_predictor(pred_dict, self.slot_size,
                                         compute_dtype)

    def encode(self, img, prev_slots=None):
        """img [B, T, H, W, 3] -> (slots [B, T, S, D], masks [B, T, S, h*w],
        visual resolution (h, w))."""
        B, T = img.shape[:2]
        feats, vis_res = self.encoder(img.reshape(B * T, *img.shape[2:]))
        feats = feats.reshape(B, T, *feats.shape[1:])
        slots, masks = [], []
        prev = prev_slots
        for t in range(T):
            if prev is None:
                init = self.init_latents.to(self.compute_dtype).expand(
                    B, -1, -1)
            else:
                init = self.predictor(prev)
            prev, mask = self.slot_attention(feats[:, t], init)
            slots.append(prev)
            masks.append(mask)
        return torch.stack(slots, 1), torch.stack(masks, 1), vis_res
