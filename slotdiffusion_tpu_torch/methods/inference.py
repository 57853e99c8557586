"""Chunked full-video inference with slot carry-over (mirrors
the JAX package's methods/inference.py:20-57): a long video runs in
`clip_len`-frame chunks, the last frame's slots seed the next chunk, and
the tail chunk is padded by repeating its last frame (the padded frames'
outputs are dropped)."""

import torch


def chunked_video_apply(apply_fn, img, clip_len, carry_key="slots",
                        keys=None):
    """apply_fn(img_chunk [B, clip_len, H, W, 3], prev_slots or None) ->
    dict of time-major [B, clip_len, ...] tensors. Returns the dict of
    outputs concatenated over time, [B, T, ...]."""
    T = img.shape[1]
    gathered = []
    prev = None
    for s in range(0, T, clip_len):
        chunk = img[:, s:s + clip_len]
        pad = clip_len - chunk.shape[1]
        if pad > 0:
            chunk = torch.cat([chunk, chunk[:, -1:].expand(
                -1, pad, *chunk.shape[2:])], dim=1)
        out = {k: v[:, :clip_len - pad] for k, v in apply_fn(
            chunk, prev).items()
            if v is not None and (keys is None or k in keys)}
        gathered.append(out)
        prev = out[carry_key][:, -1]
    return {k: torch.cat([o[k] for o in gathered], dim=1)
            for k in gathered[0]}
