"""Full-video inference (mirrors the JAX package's
methods/inference.py:20-97): `chunked_video_apply` runs a long video in
`clip_len`-frame chunks, the last frame's slots seeding the next chunk
and the tail chunk padded by repeating its last frame (the padded
frames' outputs are dropped); `interleaved_rollout` rolls a video's
slots out past its observed frames, in `frame_offset` strided
subsequences whose predictions interleave back into consecutive
frames."""

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


def interleaved_rollout(slots, rollout_fn, obs_frames, history_len,
                        frame_offset):
    """slots [B, T, N, C] of whole videos -> [B, T, N, C]: the first
    `obs_frames` as given, then the predicted rest. `rollout_fn(past
    [B, history_len, N, C], pred_len) -> [B, pred_len, N, C]`. With
    `frame_offset` k > 1 each offset s = obs_frames - history_len * k +
    o (o < k) rolls out the subsequence s, s + k, ... from its first
    `history_len` frames, and predicted frame i is the i // k-th of
    offset i % k."""
    video_len = slots.shape[1]
    total_pred = video_len - obs_frames
    assert total_pred > 0, (
        f"video_len={video_len} <= obs_frames={obs_frames}")
    obs = slots[:, :obs_frames]
    if frame_offset == 1:
        pred = rollout_fn(obs[:, -history_len:], total_pred)
    else:
        all_pred = []
        for off in range(frame_offset):
            start = obs_frames - history_len * frame_offset + off
            assert start >= 0, (
                f"obs_frames={obs_frames} too short for history_len="
                f"{history_len} x frame_offset={frame_offset}")
            in_slots = slots[:, start::frame_offset]
            all_pred.append(rollout_fn(in_slots[:, :history_len],
                                       in_slots.shape[1] - history_len))
        pred = torch.stack([all_pred[i % frame_offset][:, i // frame_offset]
                            for i in range(total_pred)], dim=1)
    return torch.cat([obs, pred.to(obs.dtype)], dim=1)
