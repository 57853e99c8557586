"""SLATE (images) and STEVE (video) (mirrors the JAX package's
models/slate.py:33-244): slot attention with its last-iteration masks
(STEVE: SAVi's, `models/savi.py` with `return_mask=True`), the frozen
dVAE tokenizer, and the AR token decoder over the dVAE's token ids,
trained with the token cross-entropy `token_recon_loss` (f32); STEVE
optionally adds the pixel `img_recon_loss` of a soft gumbel decode of
the predicted tokens at temperature 0.1. `recon_img` generates every
token with the K/V-cached decoder, takes the argmax of each position's
logits and decodes their one-hots with the dVAE.

The dVAE is frozen: the trainer takes no gradient for it
(`frozen_modules`) and the tokens come from it under `no_grad`; its
weights come from a stage-1 run's checkpoint (`training/checkpoint.py:
graft_pretrained`, `dvae_dict["dvae_ckp_path"]`). The masks stay at the
visual resolution, as the JAX models return them.
"""

import torch

from .ar_decoder import ARTransformerDecoder
from .blocks import gumbel_softmax
from .dvae import dVAE
from .sa import SlotEncoding
from .savi import SAVi


def _token_ce(out, vocab_size):
    logits = out["pred_token_id"].reshape(-1, vocab_size).float()
    target = out["target_token_id"].reshape(-1)
    return -torch.log_softmax(logits, -1).gather(1, target[:, None]).mean()


class _TokenModel:
    """What SLATE and STEVE share: the dVAE, the AR decoder over its
    tokens, the teacher-forced decode of a batch and `recon_img`."""

    ema_prefix = ""
    use_ema = False
    # the masks are served at the visual resolution, as the JAX models
    # return them
    upsample_masks = False

    def _token_parts(self, resolution, num_slots, dec_dict, dvae_dict,
                     compute_dtype):
        self.vocab_size = dvae_dict["vocab_size"]
        down = dvae_dict.get("down_factor", 4)
        self.h, self.w = resolution[0] // down, resolution[1] // down
        self.num_patches = self.h * self.w
        self.dvae = dVAE(self.vocab_size, 3, compute_dtype)
        self.trans_decoder = ARTransformerDecoder(
            self.vocab_size, dec_dict["dec_d_model"],
            dec_dict["dec_num_heads"], self.num_patches - 1, num_slots,
            dec_dict["dec_num_layers"], compute_dtype)

    @property
    def frozen_modules(self):
        return (self.dvae,)

    def _decode_tokens(self, img, slots, out, token_id=None):
        """Teacher-forced logits of the dVAE's tokens of `img` [N, H, W, 3]
        given `slots` [N, S, D]: "pred_token_id" [N, h*w, vocab] and
        "target_token_id" [N, h*w] into `out`."""
        if token_id is None:
            with torch.no_grad():
                token_id = self.dvae.tokenize(img, one_hot=False)
        target = token_id.reshape(img.shape[0], -1)
        logits = self.trans_decoder(slots, target[:, :-1])
        out["pred_token_id"] = logits[:, -self.num_patches:]
        out["target_token_id"] = target

    @torch.no_grad()
    def recon_img(self, slots, generator=None):
        """Slots [B, S, D] (or [B, T, S, D]) -> images [B(, T), H, W, 3]:
        the greedy AR generation of every token, the argmax of each
        position's logits as a one-hot, the dVAE's decode."""
        shp = slots.shape
        flat = slots.reshape(-1, *shp[-2:])
        _, logits = self.trans_decoder.generate(flat, self.num_patches,
                                                generator=generator)
        z = torch.nn.functional.one_hot(logits.argmax(-1), self.vocab_size)
        imgs = self.dvae.detokenize(z.float().reshape(
            flat.shape[0], self.h, self.w, self.vocab_size))
        return imgs.reshape(*shp[:-2], *imgs.shape[1:])


class SLATE(_TokenModel, SlotEncoding):
    """SLATE on NHWC images [B, H, W, 3]."""

    def __init__(self, resolution, slot_dict, enc_dict, dec_dict, dvae_dict,
                 loss_dict=None, eps=1e-6, compute_dtype=torch.float32):
        SlotEncoding.__init__(self, resolution, slot_dict, enc_dict, eps,
                              return_last_attn=True,
                              compute_dtype=compute_dtype)
        self._token_parts(self.resolution, self.num_slots, dec_dict,
                          dvae_dict, compute_dtype)

    def encode(self, img):
        """img [B, H, W, 3] -> slots [B, S, D], masks [B, S, h, w] at the
        visual resolution."""
        feats, vis_res = self.encoder(img)
        slots, masks = self.slot_attention(feats, self.init_slots(
            img.shape[0]))
        return slots, masks.reshape(*masks.shape[:2], *vis_res)

    def forward(self, data_dict, train=True, testing=False):
        """{"slots", "masks"}, with `testing` nothing else; else also the
        teacher-forced "pred_token_id" and "target_token_id"."""
        img = data_dict["img"]
        slots, masks = self.encode(img)
        out = {"slots": slots, "masks": masks}
        if not testing:
            self._decode_tokens(img, slots, out, data_dict.get("token_id"))
        return out

    def compute_losses(self, data_dict, generator=None, train=True):
        """-> (outputs, {"token_recon_loss": the token cross-entropy})."""
        out = self(data_dict, train=train)
        return out, {"token_recon_loss": _token_ce(out, self.vocab_size)}


class STEVE(_TokenModel, torch.nn.Module):
    """STEVE on clips [B, T, H, W, 3]."""

    def __init__(self, resolution, slot_dict, enc_dict, dec_dict, dvae_dict,
                 pred_dict, loss_dict=None, eps=1e-6,
                 compute_dtype=torch.float32):
        super().__init__()
        self.resolution = tuple(resolution)
        self.num_slots = slot_dict["num_slots"]
        self.slot_size = slot_dict["slot_size"]
        self.compute_dtype = compute_dtype
        self.savi = SAVi(self.resolution, slot_dict, enc_dict, pred_dict,
                         eps=eps, return_mask=True,
                         compute_dtype=compute_dtype)
        self._token_parts(self.resolution, self.num_slots, dec_dict,
                          dvae_dict, compute_dtype)
        self.use_img_recon_loss = bool((loss_dict or {}).get(
            "use_img_recon_loss", False))

    def encode(self, img, prev_slots=None):
        """img [B, T, H, W, 3] -> slots [B, T, S, D], masks [B, T, S, h,
        w] at the visual resolution."""
        slots, masks, vis_res = self.savi.encode(img, prev_slots)
        return slots, masks.reshape(*masks.shape[:3], *vis_res)

    def forward(self, data_dict, prev_slots=None, train=True, testing=False,
                generator=None, exp_sample=None):
        """{"slots", "masks"}, with `testing` nothing else; else also the
        teacher-forced token logits of every frame and, with
        `use_img_recon_loss`, "recon_img" [B*T, H, W, 3] (the dVAE's
        decode of a gumbel-softmax sample of the predicted tokens at tau
        0.1, drawn from `generator` or given as its Exp(1) sample
        `exp_sample`) and "gt_img"."""
        img = data_dict["img"]
        B, T = img.shape[:2]
        slots, masks = self.encode(img, prev_slots)
        out = {"slots": slots, "masks": masks}
        if testing:
            return out
        frames = img.reshape(B * T, *img.shape[2:])
        token_id = data_dict.get("token_id")
        self._decode_tokens(
            frames, slots.reshape(B * T, self.num_slots, self.slot_size), out,
            None if token_id is None else token_id.reshape(B * T, -1))
        if self.use_img_recon_loss:
            z_logits = torch.log_softmax(out["pred_token_id"], dim=-1)
            z = gumbel_softmax(z_logits, 0.1, False, -1, generator,
                               exp_sample)
            out["recon_img"] = self.dvae.detokenize(z.reshape(
                B * T, self.h, self.w, self.vocab_size))
            out["gt_img"] = frames
        return out

    def compute_losses(self, data_dict, generator=None, train=True,
                       exp_sample=None):
        """-> (outputs, {"token_recon_loss"} and, with
        `use_img_recon_loss`, the f32 MSE "img_recon_loss")."""
        out = self(data_dict, train=train, generator=generator,
                   exp_sample=exp_sample)
        losses = {"token_recon_loss": _token_ce(out, self.vocab_size)}
        if self.use_img_recon_loss:
            losses["img_recon_loss"] = ((out["recon_img"].float() -
                                         out["gt_img"].float()) ** 2).mean()
        return out, losses
