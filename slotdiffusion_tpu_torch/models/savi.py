"""SAVi encoder side with the masked slot attention (mirrors
the JAX package's models/savi.py:29-160 with `return_mask=True`).

The frame loop is a Python loop: frame 0 runs slot attention directly
from `init_latents` (tiled over the batch); every later frame, and every
frame of a continued chunk (`prev_slots` given), runs predictor -> slot
attention on the previous frame's slots.
"""

import torch

from .predictor import build_predictor
from .sa import SlotEncoding


class SAVi(SlotEncoding):
    def __init__(self, resolution, slot_dict, enc_dict, pred_dict, eps=1e-6,
                 compute_dtype=torch.float32):
        super().__init__(resolution, slot_dict, enc_dict, eps,
                         return_last_attn=True, compute_dtype=compute_dtype)
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
                init = self.init_slots(B)
            else:
                init = self.predictor(prev)
            prev, mask = self.slot_attention(feats[:, t], init)
            slots.append(prev)
            masks.append(mask)
        return torch.stack(slots, 1), torch.stack(masks, 1), vis_res
