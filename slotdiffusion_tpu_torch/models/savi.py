"""SAVi: video slot attention with the predictor carrying slots from
frame to frame (mirrors the JAX package's models/savi.py:29-191). One
class is the SAVi baseline (`build_model` of "SAVi": slot attention
without masks, the spatial broadcast decoder, the MSE
`img_recon_loss`) and the encoder of SAViDiffusion and STEVE
(`return_mask=True`, no decoder: slot attention returns its
last-iteration masks).

The frame loop is a Python loop: frame 0 runs slot attention directly
from `init_latents` (tiled over the batch); every later frame, and every
frame of a continued chunk (`prev_slots` given), runs predictor -> slot
attention on the previous frame's slots, the predictor's carry (the LSTM
wrapper's state) threaded from frame to frame and started from zeros at
each call.
"""

import torch

from .predictor import RNNPredictorWrapper, build_predictor
from .sa import SlotEncoding, SpatialBroadcastDecoder


class SAVi(SlotEncoding):
    # the trainer's contract (as SA): an EMA, when a run asks for one,
    # covers every parameter; nothing is frozen
    ema_prefix = ""
    use_ema = False
    frozen_modules = ()

    def __init__(self, resolution, slot_dict, enc_dict, pred_dict,
                 dec_dict=None, eps=1e-6, return_mask=False,
                 compute_dtype=torch.float32):
        super().__init__(resolution, slot_dict, enc_dict, eps,
                         return_last_attn=return_mask,
                         compute_dtype=compute_dtype)
        self.return_mask = return_mask
        self.predictor = build_predictor(
            pred_dict, self.slot_size, slot_dict.get("slot_mlp_size"),
            compute_dtype)
        dec_dict = dec_dict or {}
        if dec_dict.get("dec_channels"):
            self.decoder = SpatialBroadcastDecoder(
                self.resolution, tuple(dec_dict["dec_channels"]),
                tuple(dec_dict["dec_resolution"]),
                dec_dict.get("dec_ks", 5), dec_dict.get("dec_norm", ""),
                compute_dtype)
        else:
            self.decoder = None

    def _predict(self, slots, carry):
        if self.predictor is None:
            return slots, carry
        if isinstance(self.predictor, RNNPredictorWrapper):
            return self.predictor(slots, carry)
        return self.predictor(slots), carry

    def encode(self, img, prev_slots=None):
        """img [B, T, H, W, 3] -> slots [B, T, S, D] (and, with
        `return_mask`, masks [B, T, S, h*w]), then the visual resolution
        (h, w)."""
        B, T = img.shape[:2]
        feats, vis_res = self.encoder(img.reshape(B * T, *img.shape[2:]))
        feats = feats.reshape(B, T, *feats.shape[1:])
        slots, masks = [], []
        prev, carry = prev_slots, None
        for t in range(T):
            if prev is None:
                init = self.init_slots(B)
            else:
                init, carry = self._predict(prev, carry)
            out = self.slot_attention(feats[:, t], init)
            prev, mask = out if self.return_mask else (out, None)
            slots.append(prev)
            masks.append(mask)
        if self.return_mask:
            return torch.stack(slots, 1), torch.stack(masks, 1), vis_res
        return torch.stack(slots, 1), vis_res

    def decode(self, slots):
        """The baseline's spatial broadcast decoder on given slots: [BT,
        S, D] -> (image [BT, H, W, 3], per-slot RGB [BT, S, H, W, 3],
        masks [BT, S, H, W, 1])."""
        return self.decoder(slots)

    def forward(self, data_dict, prev_slots=None, train=True,
                testing=False):
        """The baseline: {"slots"} with `testing`, else also the
        decoder's "recon_img" [B, T, H, W, 3], "recons" [B, T, S, H, W,
        3] and "masks" [B, T, S, H, W, 1]."""
        img = data_dict["img"]
        B, T = img.shape[:2]
        slots = self.encode(img, prev_slots)[0]
        if testing:
            return {"slots": slots}
        recon_img, recons, masks = self.decode(
            slots.reshape(B * T, self.num_slots, self.slot_size))
        unf = lambda x: x.reshape(B, T, *x.shape[1:])
        return {"recon_img": unf(recon_img), "recons": unf(recons),
                "masks": unf(masks), "slots": slots}

    def compute_losses(self, data_dict, generator=None, train=True):
        """-> (outputs, {"img_recon_loss": the f32 MSE of the
        reconstruction}). SAVi draws nothing: `generator` is the
        trainer's protocol."""
        out = self(data_dict, train=train)
        loss = ((out["recon_img"].float() - data_dict["img"].float()) ** 2
                ).mean()
        return out, {"img_recon_loss": loss}
