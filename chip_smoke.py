#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`slotdiffusion_tpu_torch`) on one CUDA
card: build the kernels, hold each against its plain version, serve and
train the flagship SAViDiffusion, the image models (SADiffusion, SA),
the token and reconstruction baselines (SAVi, the dVAE, STEVE, SLATE),
SADiffusion with the frozen DINO ViT on COCO and VOC, and the
video-prediction and VQA stage (LDMSlotFormer, the Physion readout) at
full width, evaluate the flagship (compositional generation, FID, FVD,
test_recon with LPIPS and its cache, the epoch-end visualisation), and
report.

    python3 chip_smoke.py

Phases (one flushed line each, with elapsed seconds):
  1. the device, torch's and scipy's versions, and `nvidia-smi
     --query-gpu=name,power.limit`;
  2. build: nvcc compiles csrc/*.cu (all four kernels) into one library;
  3. every kernel against its plain PyTorch version on the card at the
     shapes the serving path gives it (collected from one denoise call and
     one encode), with its error beside the stated tolerance, a second call
     of slot attention and of GN on the same inputs that must give the
     same bits, slot attention's launch plan (cluster size, positions a
     block, resident or streamed k/v, shared memory), its device
     time per call (CUDA events around a CUDA graph of back-to-back calls)
     and its CUDA-event time over eager calls, the plain
     version's, one PyTorch call's where one computes the same function,
     and the least time the card could take (`bound_ms`); the Winograd
     kernel, which no model calls, at the flagship UNet's four ResBlock
     conv shapes (scripts/bench_winograd.py), each on its own line: the
     weight transform (`kernel_weights`, which must equal its plain
     version bit for bit), the convolution on U (`winograd_conv3x3_u`,
     the kernel's row, against `F.conv2d` with its weights already in
     bf16) and the whole call (`winograd_conv3x3`); then through its own
     entry point with the launch counts set to 0 before and read after;
     ragged edges of each kernel (slot attention: B = 1, S = 16, N that does
     not split evenly over the cluster, D not a multiple of 8 or 16, the
     largest S, D and M it takes); the GN wrapper's host cost a call, split
     into its checks, `empty_like`, the ctypes call and `Function.apply`,
     beside the same launch through its operator `sdt::group_norm`;
  3b. each kernel's autograd.Function on the card, at the largest of its
     serving shapes (Winograd: the second bench shape): the gradients of
     a random projection of its output through the kernel path against
     the plain path's (the function its backward differentiates), and
     non-zero;
  4. the flagship SAViDiffusion (MOVi-E 128x128, random weights from a
     seeded generator) answers `encode` on 2 videos x 6 frames, `sample`
     (DPM-Solver++, 20 steps, then VQ decode) and one `denoise`, with the
     kernels' launch counts set to 0 before each and read after; its
     outputs are checked for shape, dtype and finiteness, the masks for
     summing to one
     over the slots, and one denoise and one encode against the same
     model run on the CPU (the plain versions);
  5. training the same model: the three model kernels against their
     plain versions, timed and repeated for bit-identity (slot attention,
     GN), at every shape one training step gives them
     (collected from the forward + backward that sizes the batch), and
     their gradients as in 3b at the largest of those shapes; then
     `build_method` -> `Trainer.fit(max_steps=3)` on synthetic 128x128
     6-frame clips, at the config's 32 clips a step if that fits the card
     (else 16, 8 or 4), with the launch counts set to 0 before and read
     after every step; finite losses, a non-zero
     gradient on every trainable parameter outside the frozen VQ-VAE,
     parameters that moved and all three model kernels in every step;
     then a resume from the run's ckpt_last and one more step; and one
     2-clip step's gradients through the kernels against the plain
     versions;
  6. the evaluation path of the same model: `Trainer.validate` with the
     EMA on over 2 batches of 8 synthetic 128x128 6-frame clips with
     masks (losses, FG-ARI, ARI, mIoU, FG-mIoU, mBO; the launches of the
     three model kernels; the live weights bit-identical afterwards);
     the same batches and draws through the plain versions (argmax
     agreement, over all pixels and away from ties, the largest mask
     difference, each metric's and loss's difference); test_seg's
     full-video path (12 frames in chunks of 6, slots carried over);
     test_recon's batch (encode, 20 DPM-Solver++ steps, VQ decode, MSE,
     PSNR, SSIM); slot attention against its plain version at the
     trained 64x64 model's shape (B = 8, N = 4096, S = 6, D = 64,
     M = 128) with its plan, bit-identity and times; wall seconds of
     validate and of the test_recon batch beside the card's power limit;
  7. the flagship in bf16 (`use_bf16=True`, f32 parameters; the knobs
     as above), through the same code as phases 4-6: the GN and
     attention kernels' bf16 entry points against their plain twins (in
     bf16) at every shape of the bf16 serving and training paths, each
     twice on the same inputs (bit-identical), timed beside the library
     call and the bound, the totals beside phase 3's and 5's f32 ones;
     phase 4's requests (slots in bf16; masks, images and the UNet output
     in f32), and one denoise and one encode against the same bf16 model
     through the plain versions; phase 5's training, with the step times
     beside phase 5's; `Trainer.validate` as in phase 6 (its plain-version
     comparison, chunked video, test_recon and res64 shape run in f32
     only). Every request, training step and validate launches GN and
     attention only through their bf16 entries, slot attention through
     its kernel; in phases 4-6 the f32 model never reaches a bf16 entry;
  8. serving as one captured program, after phase 6 on the f32 model and
     after phase 7 on the bf16 one: `encode`, `sample` (the whole 20-step
     chain and the VQ decode) and `denoise` replayed from CUDA graphs
     (`serving.build_serving_fn`), each against the eager path of the
     same model and seed bit for bit, with the launch counts of one
     graphed request (carried over the replay) equal to the eager
     request's, and the host seconds of each path (median of 5 warm
     requests; the capture timed apart); in f32 also an in-place weight
     update that the graph reads and a parameter whose storage moves,
     which drops the graph; each surface exported (`save_artifact`:
     seconds, MB), reloaded (`load_artifact`: seconds, the first call's
     seconds) and held against the graphed path bit for bit, launches
     equal; each artifact behind `scripts/serve_model_torch.py`'s
     `make_server` on 127.0.0.1 (in bf16 `encode` alone, since phase 18
     took the script's time): `/health`, one `/predict` equal to the
     artifact's output, and a malformed request that must get a 400;
  9. the flagship's stage 1 and its handoff: `VQVAEMoviE128` at full
     width (128x128, ch 64, 4096 codes) built with `init_reference_`,
     trained by `build_method` -> `Trainer.fit(max_steps=3)` on
     synthetic single frames at the config's 64 a step, in f32 and then
     in bf16, with the LPIPS term live on a seed-0 random `.npz` written
     by the port's `save_random_lpips_npz` (passed as the config's
     `lpips_weights`): finite losses with `percept_loss` in every step, a
     non-zero gradient on every parameter, parameters that moved, no
     kernel launched (the JAX VQ-VAE runs none), step seconds and peak
     memory beside the card's name and power limit, `Trainer.validate`
     over one batch and ckpt_last.pt; 4 frames' losses on the card
     against the same model on the CPU; then that ckpt_last.pt grafted
     into the flagship SAViDiffusion through `vqvae_ckp_path` (its
     VQ-VAE bit-identical to the stage-1 model and decoding a latent
     bit-identically), which serves phase 4's requests and takes one
     training step at 4 clips, each with the counts set to 0 before and
     read after and all three model kernels launched;
 10. every sampler of the diffusion decoder at full width through
     `log_images` of 2 videos x 6 frames (random weights, seed 0), each
     with the launch counts set to 0 before and read after (61 GN and
     32 attention a UNet call through the model dtype's entries, 6 slot
     attention): DPM-Solver++ multistep, singlestep_fixed and adaptive
     (order 3), noise prediction, taylor and logSNR (20 steps), DDIM (30
     steps, `FLAGSHIP_DDIM_STEPS`; 200 before phase 17 took their time,
     50 before the margin phase 19's new files asked for)
     and the ancestral chain in f32 (over 1 video since phase 18 took
     its time; since phase 19 took its time, on the flagship with a
     `ANCESTRAL_TIMESTEPS`-step schedule: the same weights and chain
     code, 150 UNet calls, not the config's 1000); multistep and DDIM in
     bf16; DPM (dynamic thresholding) and DDIM (clamp, 30 steps) of the
     flagship UNet over 64x64 pixels (its 49,152-value GN groups through the GN
     kernel's two-pass path), and that decoder's `sample` serving surface
     eagerly and from a CUDA graph (bit for bit, the same launches). Each
     line: UNet calls, wall
     seconds, CUDA-event ms, the kernel path against a plain-path twin
     from the same x_T and noises (final VQ codes that agree, frame
     differences; a run outside its gate is repeated from an x_T one
     rounding away to tell a chaotic chain), and up to 20 of its UNet
     calls replayed on their recorded inputs through the plain versions;
 11. the image family at full width (`SALDMCLEVRTex128`: SADiffusion,
     11 slots x 3 iterations over 32x32 ResNet features, the flagship's
     LDM; random weights, seed 0): slot attention at the image shape (B =
     8, N = 1024, S = 11, D = 192, M = 384) against its plain version,
     timed, its plan and bit-identity, and GN and attention at the image
     serving shapes; `encode` of 8 images of 128x128, `sample` (20
     DPM-Solver++ steps, VQ decode) and `denoise`, eagerly and from CUDA
     graphs (bit for bit, the same launches), each with the counts set to
     0 before and read after (1 slot attention an `encode`, 61 GN and 32
     attention a UNet call); one encode and one denoise against the CPU;
     the three kernels and their gradients at a training step's shapes;
     `build_method` -> `Trainer.fit(max_steps=3)` on synthetic 128x128
     images at the config's 64 a step if they fit (else 32, 16): finite
     losses, every kernel in every step, every trainable parameter
     outside the VQ-VAE a non-zero gradient and moved; `Trainer.validate`
     over 2 batches of 16 images with masks through the kernels and the
     plain versions (phase 6's gates for 11 slots); 3 steps more from
     `init_reference_` (the training script's init: finite losses, every
     kernel in every step, the first loss the noise's mean square, as the
     zero output conv predicts 0); in bf16 one graphed `sample` against
     the eager one and one training step; then the SA baseline
     (`SACLEVRTex128`): one encode + reconstruction of the 8 images
     against the plain path, slot attention's no-mask return against its
     plain version at that shape and at the training step's, and 3
     training steps at 64 images (else 32, 16), slot attention in every
     step; wall seconds and peak memory beside the card's name and power
     limit;
 12. the token and reconstruction baselines at full width (random
     weights, seed 0): SAVi (`SAViMoviE128`: 15 slots x 2 iterations, no
     masks, the spatial broadcast decoder) refuses an `encode` surface,
     has slot attention's no-mask return held against its plain version
     at its training step's shape (B = 32 a frame, N = 1024, S = 15, D =
     192, M = 384), timed, bit-identical on a repeat, and trains 3 steps
     at the config's 32 clips x 3 frames (else 16, 8, 4) and validates 2
     batches of 8 clips with masks (its decoder's masks: FG-ARI, mIoU,
     mBO); the dVAE (`DVAEMoviE128`) trains 3 steps at 64 frames (else
     32, 16) with its gumbel temperature moving and no kernel launched
     (its one-group norms are `F.group_norm`), writing ckpt_last.pt;
     STEVE (`STEVEMoviE128`) grafts that file through `graft_pretrained`
     (its dVAE bit-identical), serves `encode` of 2 clips eagerly and from
     a CUDA graph (bit for bit, 3 slot attention launches each), trains 3
     steps at 32 clips (slot attention at its training shape checked and
     timed first), validates (losses: its masks are at the visual
     resolution and the JAX metrics take no upsampling) and reconstructs
     the 2 clips with `recon_img` (6 frames x 1024 tokens of 4096 through
     8 blocks, timed; the generation's logits against the teacher-forced
     forward on its own prefix, and its ids where the forward's top two
     logits are apart); SLATE (`SLATECLEVRTex128`: 11 slots x 3
     iterations) has slot attention checked and timed at its training
     shape (B = 64), trains 3 steps at 64 images (else 32, 16) and
     reconstructs 4 images the same way. Every training step is gated as
     in phase 11 (finite losses, slot attention in every step, every
     trainable parameter outside the frozen dVAE a non-zero gradient and
     moved); wall seconds and peak memory beside the card's name and
     power limit;
 13. COCO and VOC with the frozen DINO ViT at full width
     (`SALDMDINOCOCO224`: DINO ViT-S/8 over 224x224 images, 7 slots x
     256 x 3 iterations over its 28x28 patch tokens, the flagship's LDM
     over 56x56x3 latents; random weights, seed 0): GN, attention (784,
     196 and 49 tokens, cross-attention onto 7 slots) and slot attention
     (B = 8, N = 784, S = 7, D = 256, M = 512) at the serving shapes
     against their plain versions, timed, GN and slot attention
     bit-identical on a repeat, the count of GN calls a UNet call that
     take the two-pass path (groups over 32,768 values); the attention
     kernel's bf16 entry at 784 tokens against its plain version (at
     BF16_TOL) and beside `scaled_dot_product_attention` in bf16 and its
     bound; `encode` (masks of 224x224 summing to 1 over the
     slots), `sample` and `denoise` of 8 images eagerly and from CUDA
     graphs (bit for bit, the same launches), one encode and one
     denoise against the CPU; the kernels and their gradients at a
     training step's shapes; GN's two-pass path at (8, 384, 56, 56), the
     training batch's, (1, 384, 64, 64) and (1, 128, 128, 128), f32 and
     bf16, against its plain version and bit-identical on a repeat, timed
     at the first beside its bounds; `Trainer.fit(max_steps=3)` on
     synthetic COCO images at the config's 64 a step (else 32, 16): every
     kernel in every step, every trainable tensor a non-zero gradient and
     moved, the frozen DINO bit-identical with no gradient, step seconds
     and peak memory; `Trainer.validate` over 2 batches of 16 synthetic
     COCO images under the dual protocol (`inst/*` and `sem/*`) through
     the kernels and the plain versions (phase 6's gates); one training
     step of `SALDMDINOVOC224` (6 slots x 192) with its kernels checked
     at its shapes;
 14. the video-prediction and VQA stage (`vp_vqa`), random weights:
     `SAViLDMPhysion128` (8 slots x 192) encodes 2 in-memory videos of
     150 frames of 128x128 through `chunked_video_apply` in 6-frame
     chunks (slot attention launched every frame and held against its
     plain version at that shape; each chunk replayed through the plain
     versions from the carried slots); `LDMSlotFormerPhysion128` (a
     12-layer rollouter of 256 over 15 x 8 slot tokens, the flagship's
     LDM frozen) trains 3 steps at its 128 clips of 25 slot frames 3
     apart cut from those slots (step seconds, peak memory, every
     rollouter tensor moved, the LDM bit-identical with no gradient, the
     loss against the CPU's on 16 clips of the first batch); rolls both
     videos out by `interleaved_rollout` from 45 observed frames (3
     offsets of 35 steps; one video against the CPU); decodes 4 rollouts
     x 10 frames by DPM-Solver++ through the GN and attention kernels
     (launches per UNet call exact, the kernels at those shapes, the
     plain twin from the same x_T, every UNet call replayed through the
     plain versions, MSE/PSNR/SSIM against the videos' frames);
     `ReadoutPhysion` trains 3 steps at 64 clips of 75 frames and
     validates 128 (the accuracies; logits against the CPU);
 15. the trainer's optimizers and settings on the flagship at full width
     (32 clips x 6 frames, f32, random weights): `adam_fused`,
     `adam_bf16`, `adamw` (weight decay 0.01), `adafactor` and `sgd`
     train 3 steps each through `Trainer.fit` and the config's
     `max_steps` (step seconds, peak memory, the optimizer state's bytes,
     every trainable tensor moved, the frozen VQ-VAE bit-identical, the
     first update on 6 tensors against the same core's on the CPU from
     the same gradients: 1e-6 relative, the f32 state 2e-5, bf16 moments
     within one ulp;
     `adam_fused` against `adam` too); SAVE_STEPS steps with a save after
     each,
     blocking then `async_ckpt` (the seconds the loop blocked, ckpt_last
     bit-identical to the live model); a torch.profiler trace of 2 steps
     that must name `sdt::group_norm`, `sdt::mha` and
     `sdt::sa_iterations`; the model through
     `export_reference_state_dict`, a DDP-wrapped `.pth` with an LPIPS
     head and scripts/convert_checkpoint_torch.py into a fresh model,
     whose graphed `encode` and `denoise` equal the original's bit for
     bit;
 16. what evaluation lacked until now, on the flagship at full width
     (random weights, seed 0): 2 in-memory videos of 16 frames encoded
     (slot attention at those shapes against its plain version), their
     slots recombined by `shuffle_slots` (slot k of video b is slot k of
     video (b - k) mod 2, checked exactly) and decoded by `decode_slots`
     (20 DPM-Solver++ steps, the VQ decode; 61 GN and 32 attention
     launches a UNet call exactly; GN and attention at those shapes
     against their plain versions; one video against its plain twin from
     the same x_T, every UNet call replayed, as phase 14's decode); FID
     and FVD of the 32 composed frames against the 32 real ones on seeded
     stand-in networks (`save_random_inception_npz`,
     `save_random_i3d_npz`, whose arrays the converters give bit for bit
     from the same state dicts), their features on the card against the
     CPU, ms an image or clip, the distances under
     `fid(untrained-weights)` and `fvd(untrained-weights)`; test_recon's
     loop (`methods.evaluation.recon_eval`) over 2 batches of those clips
     with a seeded LPIPS `.npz`, FID and FVD, then again over its cache
     (no kernel, no UNet call, the same FINAL line), its 64 frame dumps
     read back by the port's PNG reader; the viz: the flagship's callback
     through DPM-Solver++ (`VIZ_DPM`; its config's 1000-step ancestral
     chain, 30-43 s, gave way to phase 17's time, and phase 10 runs that
     chain) on 2 videos x 6 frames (launches per UNet call exact), SA's
     (`SACLEVRTex128`) on 8
     images, and one `Trainer.validate` with a checkpoint directory that
     draws it, each PNG / APNG read back at its expected size. The
     earlier phases that train or validate with a checkpoint directory
     (5, 7, 9, 11-15) set `use_viz=False`: the flagship's chain takes ~30
     s a validation, and this phase draws every kind of viz;
 17. scale-out and cross-device export (`parallel/`, `serving.py`): the
     flagship at full width (random weights, seed 0) trains SCALE_STEPS
     steps at SCALE_CLIPS clips a global step in
     `torch.cuda.device_count()` ranks over NCCL (one process a card,
     started through `parallel.maybe_initialize_distributed` from
     torchrun's variables), data parallel (DDP), each rank's launches of
     GN, attention and slot attention counted in every step, its step
     seconds and one all-reduce of the step's gradient bytes timed
     alone; the losses against one process on the same global batch
     (SCALE_LOSS_RTOL), rank 0's ckpt_last loaded into that one-process
     trainer and its state read back bit for bit; with 2 or more cards
     TP = 2 and FSDP runs too, with one card 2 ranks of DDP on that card
     over gloo (CUDA tensors) at 2 clips a rank; the world size, backend
     and plans on a line of their own; each rank's state on its card
     (`memory_allocated` as the trainer lets it go) against
     `parallel.aot`'s prediction from shard shapes, within the caching
     allocator's rounding (`held_state_bytes`). Then `encode`, `denoise` and
     `sample` exported for `cuda` by a process that sees no card
     (`CUDA_VISIBLE_DEVICES=""`, `save_artifact(devices=("cuda",))`),
     loaded on the card beside the same surfaces exported on the card:
     the answers must be bit-identical; export and load seconds;
 18. per-card memory under each plan (`parallel/aot.py`) and the
     optimizers the plans took last: the flagship's step at the local
     batch of SIZING_CARDS cards under DP (this process), TP 2
     (`adam_fused`) and FSDP 2 (`adafactor`; 2 gloo ranks on the one
     card each, both runs side by side), SIZING_STEPS steps each with
     LAUNCHES_PER_STEP launches a step exactly, the activation peak of
     the last step, each rank's state on the card against `parallel.aot`
     as in phase 17, each run's trained state against one process's on
     the same global batch (`state_distance`; SCALE_STATE_TOL, bf16
     kinds BF16_STATE_TOL, the rows ZERO_GRADIENT names and the elements
     whose first gradient is noise left out); then the sizing table of
     SIZING_CARDS cards with the measured peaks;
 19. the data layer from files (DATA_FIXTURE, the committed tree and what
     the JAX readers return for it): the machine's compiler, image
     libraries, PIL and CPUs; the port's native decode library built with
     g++; with PIL's import blocked, every reader over the tree against
     the JAX readers' references, every item bit for bit (the tree's
     progressive, arithmetic-coded and arithmetic progressive JPEGs, its
     interlaced PNGs and its 16-bit and tRNS masks among them); the
     flagship's
     input rate (MOVi train split, 128x128, 6-frame clips, batches of 8)
     at 0 and min(8, cpu_count) spawned loader workers beside the clips a
     second phase 5's step consumes; 2 training steps of the flagship from
     the tree through `Trainer` (every step launches the three model
     kernels) and `Trainer.validate` on the tree's 8 validation clips with
     FG-ARI and mIoU from the file masks, against the plain versions;
 20. one JSON line listing every kernel (times per serving request;
     `train_ms` / `train_plain_ms`: per training step's forward calls;
     `res64_*`: slot attention at the 64x64 model's shape; `img_*`: slot
     attention at the image shape, per image `encode`; `savi_train_*`,
     `steve_train_*`, `slate_train_*`: slot attention per training step's
     forward calls of each baseline, and `baseline_seconds` their wall
     and event times; `coco_*`: each model kernel at phase 13's serving
     shapes; `long_run_*`: GN's two-pass path at (8, 384, 56, 56);
     `sdpa_bf16_*` (on the bf16 attention row): the bf16 entry at 784
     tokens against SDPA, its plain version and its bound;
     the bf16 entry
     points of GN and attention as entries of their own, `"entry"` and
     `"dtype": "bf16"` marking them, with the f32 entry's times beside),
     then the card's name and power limit, then the result line.

It exits non-zero, printing no result line, when there is no CUDA card,
when the port is not beside it, or when any phase fails. Matmuls and
convolutions run in full f32 (TF32 off) so that the comparisons hold the
kernels' f32 arithmetic.
"""

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

T0 = time.time()

# H100 SXM peaks (NVIDIA data sheet, at the 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12     # f32 outside the tensor cores
BF16_FLOPS = 989e12   # dense bf16 tensor-core rate
TF32_FLOPS = 495e12   # dense TF32 tensor-core rate

# tolerances of kernel vs plain version on the card, and why
TOL = {
    # f32 statistics summed in another order: ~1e-6 on unit-scale outputs
    "gn_silu": 1e-4,
    # f32 logits and sums taken in another order than the matmul's
    "attention": 1e-4,
    # k, v, q and the weights are rounded to bf16 at the same points on
    # both sides; where the f32 value differs in its last bits a rounding
    # can land one bf16 ulp (2^-8) apart in one term of a 192-long sum,
    # which the GRU and MLP carry to slots of magnitude ~10
    "slot_attention": 2e-3,
}
# Winograd, relative to the output's largest magnitude: U and V are
# rounded to bf16 at the same points in the kernel and its plain version,
# whose f32 sums run in another order, so a bf16 output can land one bf16
# ulp apart: 2^-7 of the largest magnitude bounds that ulp. Against the
# f32 direct conv: 3e-2, the JAX package's tests/test_winograd.py class
WINO_TOL, WINO_F32_TOL = 2.0 ** -7, 3e-2
# 3b: the kernel path's gradients against the plain path's, relative to
# the largest gradient: both backwards run the same plain function on the
# same inputs, so only summation order (cuDNN's bf16 conv for Winograd)
GRAD_TOL = {"gn_silu": 1e-5, "attention": 1e-5, "slot_attention": 1e-5,
            "winograd_conv3x3": 1e-2}
# 5: one 2-clip training step's gradients, kernels vs plain versions,
# relative to each parameter's largest gradient (or a hundredth of the
# model's largest, where a gradient is zero in exact arithmetic): the
# kernel path rounds slot attention's k, v, q and weights to bf16
# (2^-8 relative), which moves the slots and every gradient that depends
# on them; measured 1.3e-3 on an H100 (largest at the predictor)
TRAIN_GRAD_TOL = 1e-2
MODEL_KERNELS = ("gn_silu", "attention", "slot_attention")
DETERMINISTIC = ("gn_silu", "slot_attention")  # checked bit for bit
TRAIN_BATCHES = (32, 16, 8, 4)  # clips a step: the config's, then cuts
TRAIN_STEPS = 3
# 7 (bf16): kernel vs plain twin, both bf16 out, relative to the output's
# largest magnitude. GN: the f32 statistics are summed in another order,
# so a value can round one bf16 ulp apart, and one ulp is at most 2^-7 of
# the largest value. Attention: the normalized weights are rounded to
# bf16 at the same point on both sides (JAX's), after f32 sums taken in
# another order, so a weight can round one ulp (2^-8 relative) apart and
# move an output by 2^-8 of a |v|; then the output's own rounding: 2^-7
# of the largest output bounds both at these shapes
BF16_TOL = {"gn_silu_bf16": 2.0 ** -7, "attention_bf16": 2.0 ** -7}
BF16_KERNELS = ("gn_silu_bf16", "attention_bf16", "slot_attention")
# 7: the bf16 model through the kernels vs through the plain versions on
# the card, relative to the output's largest magnitude: the same bf16
# roundings except where a kernel's sum order moves one by an ulp, which
# ~100 bf16 layers carry on (measured on an H100: denoise 2.0e-2, encode
# slots 1.1e-3, masks 2.8e-5)
BF16_PATH_TOL = 5e-2
# 7: the 2-clip step's gradients, kernels vs their plain twins (slot
# attention's with bf16 k/v), as TRAIN_GRAD_TOL; in bf16 every activation
# is rounded to 2^-8 relative, and where a kernel's sum order lands a
# rounding one ulp apart, every gradient behind it moves (measured 2.1e-2
# on an H100, largest at the predictor)
BF16_TRAIN_GRAD_TOL = 1e-1
# 6: validation over EVAL_BATCHES batches of EVAL_BATCH clips, kernels vs
# plain versions (slot attention's bf16 twin). The masks may differ by
# slot attention's error (the largest mask difference is held to
# TOL["slot_attention"]; measured 1.4e-4 to 2.1e-4 on an H100), so a
# pixel's argmax can flip where the plain path's two largest masks are
# within twice that of each other; with random weights most pixels'
# masks sit near 1/15 each. Measured on an H100: the argmax agrees at
# 0.997660 to 0.998336 of the pixels (four runs of this script), 92% of
# the pixels have their two largest masks within ARGMAX_TIE of each other
# (one run), a metric moves by at most 2.7e-4 (four runs). The gates: the
# argmax agrees on every pixel whose two largest plain masks are more
# than ARGMAX_TIE apart; the exact share over all pixels is at least
# ARGMAX_EXACT (the near-ties make that share sensitive to the kernel's
# error, which TOL bounds only loosely); each metric moves by at most
# SEG_METRIC_TOL (about the share of pixels that flip, 7x the largest
# measured move); the losses by 1e-3 relative (f32 sums in another order)
EVAL_BATCH, EVAL_BATCHES = 8, 2
# 8: warm requests a median of host seconds is over (5 before phase 18
# took the script's time)
GRAPH_REQUESTS = 3
ARGMAX_TIE = 2 * TOL["slot_attention"]
ARGMAX_EXACT = 0.995
LOSS_RTOL = 1e-3
SEG_METRIC_TOL = 2e-3
# 9: the stage-1 VQ-VAE's steps a dtype, the frames its card-vs-CPU loss
# check takes (the CPU runs the 128x128 model at a few seconds a frame),
# and the clips of stage 2's one training step on the grafted flagship
STAGE1_STEPS = 3
STAGE1_CPU_FRAMES = 4
STAGE2_CLIPS = 4
# 10: every sampler of the decoder through `log_images` (2 videos x the
# clip's frames): (name, model, `log_images` keywords, frames of the
# plain-path twin or None for all 12; 1: the whole run over 1 video).
# "f32" and "bf16" are the flagship (latent), "pixel" its UNet over 64x64
# pixels with no VQ-VAE. Two twins are cut to the first frame of each
# video: ancestral's 1000 steps and the pixel decoder's DDIM (the widths
# never are). The pixel decoder's DDIM
# takes PIXEL_DDIM_STEPS steps, not the default 200: at 64x64 a UNet call
# over the 12 frames takes 0.22 s, and 200 of them put the script past
# half its time limit; the flagship's DDIM takes FLAGSHIP_DDIM_STEPS too
# since phase 17 came (its 200 steps with their twins and controls took
# ~30 s a dtype)
DPM = dict(use_dpm=True, steps=20, order=3)
PIXEL_DDIM_STEPS = FLAGSHIP_DDIM_STEPS = 30
# the ancestral chain takes every step of its schedule (1000 UNet calls
# and as many for its twin: 75-102 s by host); it runs on the flagship
# with this many steps in the schedule (its linear betas over them; 250
# until the script's margin under its limit asked for less)
ANCESTRAL_TIMESTEPS = 150
SAMPLER_RUNS = (
    ("dpm++ multistep", "f32", dict(DPM, method="multistep"), None),
    ("dpm++ singlestep_fixed", "f32", dict(DPM, method="singlestep_fixed"),
     None),
    ("dpm++ adaptive", "f32", dict(use_dpm=True, order=3,
                                   method="adaptive"), None),
    ("dpmsolver (noise prediction)", "f32",
     dict(DPM, algorithm_type="dpmsolver"), None),
    ("dpm++ taylor", "f32", dict(DPM, solver_type="taylor"), None),
    ("dpm++ logSNR", "f32", dict(DPM, skip_type="logSNR"), None),
    ("ddim", "f32", dict(use_dpm=False, use_ddim=True,
                         steps=FLAGSHIP_DDIM_STEPS), None),
    # over 1 video (its twin its first frame; 2 videos before phase 18
    # took the script's time), on the flagship with an
    # ANCESTRAL_TIMESTEPS-step schedule ("f32_short"; the config's 1000
    # steps before phase 19 took the script's time)
    ("ancestral", "f32_short", dict(use_dpm=False), 1),
    ("dpm++ multistep", "bf16", dict(DPM, method="multistep"), None),
    ("ddim", "bf16", dict(use_dpm=False, use_ddim=True,
                          steps=FLAGSHIP_DDIM_STEPS), None),
    ("dpm++ (dynamic thresholding)", "pixel", dict(use_dpm=True), None),
    ("ddim (clamp)", "pixel", dict(use_dpm=False, use_ddim=True,
                                   steps=PIXEL_DDIM_STEPS), 2),
)
# 10: kernel path vs plain-path twin, the same x_T and per-step noises
# (same_noise: one draw a step, whatever the batch). Latent decoders: the
# share of latent positions whose final VQ code agrees must reach
# CODE_AGREE (quantize-as-denoise at every model call: a rounding that
# moves x0 across a code boundary moves the chain there), and frames
# whose codes all agree decode within SAME_CODE_TOL of the frame scale
# (the same plain VQ decode, batched otherwise). Pixel decoder: frames
# within PIXEL_TOL of the frame scale. The values are the predictions
# written in PERF.md before the phase first ran. That run showed
# a chain whose update reads the model's eps directly (DDIM) losing every
# code over 200 steps at these random weights, so a run outside its gate
# is run once more through the kernels from an x_T moved by CONTROL_EPS
# (relative): when that control is outside the gate too, the chain itself
# is chaotic and the end-to-end numbers are reported, not gated; else the
# run fails. Every run is also held call by call: up to CHECKED_CALLS of
# its UNet calls, spread over the chain, replayed on their recorded
# inputs through the plain versions, within PER_CALL_TOL of the output's
# scale (f32: card vs CPU 2.7e-6 in phase 4; bf16: BF16_PATH_TOL, whose
# measured value is 2.0e-2)
CODE_AGREE = {"dpm": 0.99, "ddim": 0.9, "ancestral": 0.9, "bf16": 0.5}
SAME_CODE_TOL = 1e-4
PIXEL_TOL = {"dpm": 1e-3, "ddim": 1e-2}
CONTROL_EPS = 2.0 ** -20
CHECKED_CALLS = 20
PER_CALL_TOL = {"f32": 1e-4, "bf16": 5e-2}
GN_PER_UNET, ATTN_PER_UNET = 61, 32
# the pixel decoder's side: the flagship UNet's largest GN group is 12
# channels (384 after the skip concat, 32 groups) at full resolution,
# 12 x 64^2 = 49,152 values, over the 32,768 of the GN kernel's
# single-read path: its two-pass path takes them; PIXEL_SERVE videos of
# PIXEL_SERVE_FRAMES frames through the `sample` surface
PIXEL_SIDE = 64
PIXEL_SERVE, PIXEL_SERVE_FRAMES = 1, 2

# 11: the image family. SADiffusion (`SALDMCLEVRTex128`) serves IMG_SERVE
# images of 128x128; trains IMG_STEPS steps at the first of
# IMG_TRAIN_BATCHES that fits (the config's 64, then cuts); validates
# IMG_EVAL_BATCHES batches of IMG_EVAL_BATCH images. SA (`SACLEVRTex128`)
# trains IMG_STEPS steps the same way. Validation's kernel-vs-plain gates
# are phase 6's, restated for 11 slots: at random weights a pixel's 11
# masks sit near 1/11 each, and slot attention's error (TOL, bf16 k/v
# rounded one ulp apart) can swap two masks within ARGMAX_TIE of each
# other, as with 15; away from such ties the argmax must agree, and the
# exact share over all pixels must reach ARGMAX_EXACT
IMG_SERVE = 8
IMG_TRAIN_BATCHES = (64, 32, 16)
IMG_STEPS = 3
IMG_EVAL_BATCH, IMG_EVAL_BATCHES = 16, 2
IMG_SLOTS = 11
# 11: kernel path vs plain path on the card (SA's encode + reconstruction),
# relative to each output's largest magnitude: slot attention's bf16 k/v
# may round one ulp apart (TOL), which the GRU and MLP carry to the slots
# and the decoder to the image, as phase 4's encode (1e-2)
IMG_PATH_TOL = 1e-2
# 12: the token and reconstruction baselines. SAVi (`SAViMoviE128`) and
# STEVE (`STEVEMoviE128`) train BASE_STEPS steps at the first of
# BASE_TRAIN_BATCHES clips that fits (the configs' 32, then cuts), the
# dVAE (`DVAEMoviE128`) at the first of DVAE_BATCHES frames, SLATE
# (`SLATECLEVRTex128`) at the first of IMG_TRAIN_BATCHES images; SAVi and
# STEVE validate BASE_EVAL_BATCHES batches of BASE_EVAL_BATCH clips; STEVE
# serves and reconstructs RECON_CLIPS clips, SLATE reconstructs
# RECON_IMAGES images
BASE_TRAIN_BATCHES = (32, 16, 8, 4)
DVAE_BATCHES = (64, 32, 16)
BASE_STEPS = 3
BASE_EVAL_BATCH, BASE_EVAL_BATCHES = 8, 2
RECON_CLIPS, RECON_IMAGES = 2, 4
# 12: KV-cached generation against the teacher-forced forward on the
# generated prefix: the same f32 formulas, a one-token attention over the
# cache against the full causal one, summed in another order; relative to
# the logits' largest magnitude
GEN_TOL = 1e-3
# 13: COCO and VOC with the frozen DINO ViT. SADiffusion
# (`SALDMDINOCOCO224`: 7 slots x 256, 3 iterations over DINO's 28x28
# patch tokens, the flagship's LDM over 56x56x3 latents) serves IMG_SERVE
# images of 224x224, trains COCO_STEPS steps at the first of
# COCO_TRAIN_BATCHES that fits (the config's 64, then cuts) and validates
# COCO_EVAL_BATCHES batches of COCO_EVAL_BATCH synthetic COCO images
# under the dual inst/sem protocol; `SALDMDINOVOC224` (6 x 192) trains
# VOC_STEPS at the COCO batch
COCO_TRAIN_BATCHES = (64, 32, 16)
COCO_STEPS = 3
COCO_EVAL_BATCH, COCO_EVAL_BATCHES = 16, 2
VOC_STEPS = 1
# 13: the GN kernel's two-pass path (groups over 32,768 values) at each
# (B, C, H, W), 32 groups, B None the COCO training batch: the UNet's
# 384-channel norm at 56x56 latents (37,632 values a group), the pixel
# decoder's at 64x64 (49,152), 128 channels at 128x128 (65,536); against
# `group_norm_reference` relative to the largest output, f32 and bf16
# (one bf16 rounding of the output: 2^-8 relative, twice that allowed);
# timed at the first
GN_LONG_SHAPES = ((8, 384, 56, 56), (None, 384, 56, 56), (1, 384, 64, 64),
                  (1, 128, 128, 128))
GN_LONG_TOL = {"f32": 1e-4, "bf16": 2.0 ** -7}
# 13: the bf16 entry's other routes (GN_LONG_SHAPES' bf16 runs take the
# bulk route, through shared memory): (B, C, H, W, groups, route), a run
# of 2,097,152 values, over what shared memory holds (two passes), and
# runs of 252 values (not a multiple of 8: the register kernel)
GN_BF16_ROUTE_CASES = ((1, 32, 256, 256, 1, "two_pass"),
                       (5, 96, 7, 9, 24, "ragged"))
# 11: the first training step from `init_reference_`, whose zero UNet
# output conv predicts eps = 0: its loss is the mean square of the
# Gaussian noise, 1 in expectation with a standard deviation of
# sqrt(2 / n), 0.0032 over 64 images' 32x32x3 latents (0.0064 at 16);
# 0.05 is 8 of those at 16 images
REF_INIT_LOSS_TOL = 0.05
# 14: the video-prediction and VQA stage at full width. SAViDiffusion
# (`SAViLDMPhysion128`, 8 slots x 192) encodes VP_VIDEOS in-memory videos
# of VP_FRAMES frames in chunks of its 6-frame clip; LDMSlotFormer
# (`LDMSlotFormerPhysion128`) trains VP_STEPS steps at its 128 clips of
# 25 slot frames 3 apart, cut from those slots, and rolls the videos out
# from VP_OBS observed frames; VP_DECODE rollouts of 10 frames are
# decoded by its LDM (DPM-Solver++, 20 steps); the readout
# (`ReadoutPhysion`) trains READOUT_STEPS steps at its 64 and validates
# READOUT_VAL clips. Gates: each chunk of the encode replayed through the
# plain versions from the kernel path's carried slots within VP_ENC_TOL of
# each output's scale (phase 4's encode tolerance: a 6-frame chunk of
# SAVi, each frame's slot attention with bf16 k/v); the card against the
# CPU, f32 with TF32 off and sums in another order: the slot loss of
# VP_CPU_CLIPS clips within LOSS_RTOL, the rollout of one video (105
# autoregressive steps over 3 offsets) within VP_ROLL_TOL of its scale,
# the readout's logits within VP_ROLL_TOL; the decode as phase 10's DPM
# runs (CODE_AGREE["dpm"], SAME_CODE_TOL, PER_CALL_TOL["f32"], with the
# control when outside)
VP_VIDEOS, VP_FRAMES, VP_OBS = 2, 150, 45
VP_STEPS, VP_DECODE, VP_CPU_CLIPS = 3, 4, 16
READOUT_STEPS, READOUT_VAL = 3, 128
VP_ENC_TOL, VP_ROLL_TOL = 1e-2, 1e-3


def log(msg):
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


PHASE_MARKS = []  # (phase, seconds since T0 at its start), in run order


def mark(phase):
    PHASE_MARKS.append((phase, time.time() - T0))


def phase_times():
    """Each phase's seconds by the script's clock, in run order, after the
    start-up before the first one."""
    ends = [t for _, t in PHASE_MARKS[1:]] + [time.time() - T0]
    return [("start", PHASE_MARKS[0][1])] + [
        (p, end - t) for (p, t), end in zip(PHASE_MARKS, ends)]


def timed(fn, iters=20, warmup=3, reps=5):
    """(device ms, event ms) per call. Device ms: CUDA events around the
    replay of a CUDA graph that holds `iters` calls, over `iters`; the
    median of `reps` replays. The graph launches the calls with no host
    work between them, so this is the card's time for the work. Event ms:
    CUDA events around `iters` back-to-back eager calls, which include the
    host's launch cost whenever the host is slower than the device (small
    shapes)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # compile and allocate before capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    event_ms = start.elapsed_time(end) / iters
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(reps):
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    del graph
    return sorted(per_call)[reps // 2], event_ms


def bound_terms(nbytes, f32_ops=0.0, bf16_ops=0.0, tf32_ops=0.0):
    """(ms to move the bytes, ms to do the operations) at the peaks: each
    input read once, each output written once; operations at the rate of
    the unit that does them (`tf32_ops`: TF32 tensor-core products, three
    for each f32-accurate one in the 3xTF32 split)."""
    return (1e3 * nbytes / HBM_BYTES_PER_S,
            1e3 * (f32_ops / F32_FLOPS + bf16_ops / BF16_FLOPS +
                   tf32_ops / TF32_FLOPS))


def record_shapes(model):
    """Forward-pre hooks on `model`'s kernel modules that count its kernel
    calls by shape; -> ({kernel: {shape key: calls}}, hook handles)."""
    from slotdiffusion_tpu_torch.models.blocks import GroupNorm32
    from slotdiffusion_tpu_torch.models.slot_attention import SlotAttention
    from slotdiffusion_tpu_torch.models.unet import CrossAttention
    shapes = {name: {} for name in MODEL_KERNELS}

    def count(name, key):
        shapes[name][key] = shapes[name].get(key, 0) + 1

    def gn_hook(mod, args):
        if mod.fused:
            count("gn_silu", (tuple(args[0].shape), mod.act, mod.eps,
                              mod.num_groups))

    def attn_hook(mod, args):
        x, ctx = args[0], (args[1] if len(args) > 1 else None)
        nk = x.shape[1] if ctx is None else ctx.shape[1]
        count("attention", (x.shape[0], x.shape[1], nk, mod.num_heads))

    def sa_hook(mod, args):
        count("slot_attention", (args[0].shape[0], args[0].shape[1],
                                 args[1].shape[1],
                                 mod.project_k.out_features,
                                 mod.mlp[1].out_features,
                                 mod.num_iterations, mod.return_last_attn))

    handles = [m.register_forward_pre_hook(fn) for m in model.modules()
               for cls, fn in ((GroupNorm32, gn_hook),
                               (CrossAttention, attn_hook),
                               (SlotAttention, sa_hook))
               if isinstance(m, cls)]
    return shapes, handles


def serving_shapes(model, inputs):
    """{kernel: {shape key: calls}} of one encode and one denoise request
    on `inputs` (`serving_inputs`), by `record_shapes`."""
    import torch
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    video, x_t, t_model = inputs
    shapes, handles = record_shapes(model)
    slots, _ = build_serving_fn(model, "encode", graphed=False)(video)
    build_serving_fn(model, "denoise", graphed=False)(x_t, t_model, slots)
    torch.cuda.synchronize()
    for hk in handles:
        hk.remove()
    return shapes


def kernel_cases(shapes, sa_mod, gen, dev):
    """For each kernel call shape in `shapes` (from `record_shapes`), on
    random inputs of that shape: (name, calls, label, kernel call, plain
    call, library call or None, bound terms)."""
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    for (shape, act, eps, G), calls in sorted(shapes["gn_silu"].items(),
                                              key=lambda kv: str(kv[0])):
        C = shape[1]
        xg = torch.randn(shape, generator=gen, device=dev) * 2 + 0.5
        wg = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bg = 0.1 * torch.randn(C, generator=gen, device=dev)
        n = xg.numel()
        yield ("gn_silu", calls, f"{tuple(shape)} act={act} eps={eps:g}",
               lambda: fused_norm.fused_group_norm(xg, wg, bg, G, eps, act),
               lambda: fused_norm.group_norm_reference(xg, wg, bg, G, eps,
                                                       act),
               (lambda: F.silu(F.group_norm(xg, G, wg, bg, eps)))
               if act == "silu" else
               (lambda: F.group_norm(xg, G, wg, bg, eps)),
               bound_terms(2 * n * 4 + 2 * C * 4,
                           f32_ops=(10 if act else 6) * n))
    for (Bq, nq, nk, heads), calls in sorted(shapes["attention"].items()):
        hd = heads * attention_kernel.HEAD_DIM
        q = torch.randn(Bq, nq, hd, generator=gen, device=dev)
        k = torch.randn(Bq, nk, hd, generator=gen, device=dev)
        v = torch.randn(Bq, nk, hd, generator=gen, device=dev)
        split = lambda t: t.view(Bq, t.shape[1], heads, -1).transpose(1, 2)
        yield ("attention", calls, f"B={Bq} Nq={nq} Nk={nk} H={heads}",
               lambda: attention_kernel.fused_mha(q, k, v, heads),
               lambda: attention_kernel.mha_reference(q, k, v, heads),
               lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                      split(v)),
               # q k^T and e v on the tensor cores, each f32 product as
               # three TF32 ones (3xTF32)
               bound_terms(4 * (2 * q.numel() + 2 * k.numel()),
                           tf32_ops=3 * 4.0 * Bq * nq * nk * hd))
    p = {key: val.detach().contiguous() for key, val in
         sa_mod.kernel_weights().items()} if shapes["slot_attention"] else {}
    for (Bs, N, S, D, M, iters, last), calls in sorted(
            shapes["slot_attention"].items()):
        ks = torch.randn(Bs, N, D, generator=gen, device=dev)
        vs = torch.randn(Bs, N, D, generator=gen, device=dev)
        s0 = torch.randn(Bs, S, D, generator=gen, device=dev)
        kw = dict(num_iterations=iters, eps=sa_mod.eps,
                  return_last_attn=last)
        # the last iteration's masks are written only when returned
        nbytes = (2 * Bs * N * D * 2 + 2 * Bs * S * D * 4 +
                  last * Bs * S * N * 4 + 4 * (D * D + 6 * D * D + 2 * D * M))
        mm = 2.0 * Bs * iters * S
        plan = slot_attention_kernel.launch_plan(Bs, N, S, D, M)
        yield ("slot_attention", calls,
               f"B={Bs} N={N} S={S} D={D} iters={iters} "
               f"{'with' if last else 'without'} masks plan {plan} "
               f"({slot_attention_kernel.active_clusters(plan)} such "
               "clusters at once on this card)",
               lambda: slot_attention_kernel.sa_iterations(ks, vs, s0, p,
                                                           **kw),
               lambda: slot_attention_kernel.sa_iterations_ref(ks, vs, s0,
                                                               p, **kw),
               None,
               # q k and a v on the bf16 tensor cores; the Wq, GRU and MLP
               # products as three TF32 products each (3xTF32)
               bound_terms(nbytes, bf16_ops=mm * 2 * N * D,
                           tf32_ops=3 * mm * D * (D + 6 * D + 2 * M)))


def sa_weight_shapes(D, M):
    """Slot attention's weight shapes (SA_WEIGHT_KEYS) at widths D, M."""
    return {"wq": (D, D), "ln_q_scale": (D,), "ln_q_bias": (D,),
            "gru_wi": (D, 3 * D), "gru_bi": (3 * D,), "gru_wh": (D, 3 * D),
            "gru_bh": (3 * D,), "ln_mlp_scale": (D,), "ln_mlp_bias": (D,),
            "w1": (D, M), "b1": (M,), "w2": (M, D), "b2": (D,)}


def gn_host_split(dev, calls=2000):
    """Host microseconds a GN call at a small UNet shape (12 x 512 x 4 x 4,
    where the device needs ~3 us): the wrapper's checks, `empty_like`, the
    stream pointer, the ctypes call alone (launch included), the whole
    wrapper under inference mode (serving), the `sdt::group_norm`
    operator (what an exported program calls) and the wrapper with a
    gradient to track (`Function.apply`, training); each the host clock
    over `calls` calls ending in a synchronize, so each includes what the
    card's queue adds when the host outruns it."""
    import torch
    from slotdiffusion_tpu_torch.ops import _cuda, fused_norm
    x = torch.randn(12, 512, 4, 4, device=dev)
    w, b = torch.ones(512, device=dev), torch.zeros(512, device=dev)
    y = torch.empty_like(x)
    lib = _cuda.lib()

    def per_call(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / calls * 1e6

    stream = _cuda.stream_ptr(dev)
    wg = w.clone().requires_grad_()
    with torch.inference_mode():
        split = {
            "checks": per_call(lambda: fused_norm.check_inputs(
                x, w, b, 32, "silu")),
            "empty_like": per_call(lambda: torch.empty_like(x)),
            "stream_ptr": per_call(lambda: _cuda.stream_ptr(dev)),
            "ctypes_call": per_call(lambda: lib.sdt_group_norm_f32(
                x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), 12,
                512, 16, 32, 1e-5, 1, None, 0, stream)),
            "wrapper_inference": per_call(lambda: fused_norm.fused_group_norm(
                x, w, b, 32, 1e-5, "silu")),
            # the same launch through the dispatcher (`sdt::group_norm`,
            # the node an exported program calls)
            "operator": per_call(lambda: torch.ops.sdt.group_norm(
                x, w, b, 32, 1e-5, True)),
        }
    split["wrapper_function_apply"] = per_call(
        lambda: fused_norm.fused_group_norm(x, wg, b, 32, 1e-5, "silu"))
    return split


def max_err(a, b):
    """Largest absolute difference over one output or a tuple of them."""
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return max((x.float() - y.float()).abs().max().item()
               for x, y in zip(a, b))


def record(results, failed, phase, name, calls, label, err, tol, k_t, p_t,
           l_t, terms):
    """Log one shape's check and times; add `calls` of them to the
    kernel's totals in `results`, and the shape to `failed` if the error
    exceeds `tol`."""
    (k_ms, k_ev), (p_ms, p_ev) = k_t, p_t
    l_ms, l_ev = l_t if l_t is not None else (None, None)
    b_ms = max(terms)
    b_by = "bytes" if terms[0] >= terms[1] else "operations"
    ok = err <= tol
    if not ok:
        failed.append(f"{name} {label}")
    lib = "n/a" if l_ms is None else \
        f"{l_ms:.4f} ({l_ev:.4f}), kernel/library {k_ms / l_ms:.3f}"
    log(f"{phase}: {name} {label} x{calls}: max_abs_err {err:.3e} "
        f"(tol {tol:.1e}) {'ok' if ok else 'FAIL'} | device "
        f"(event) ms: kernel {k_ms:.4f} ({k_ev:.4f}), plain "
        f"{p_ms:.4f} ({p_ev:.4f}), library {lib}, bound {b_ms:.4f} "
        f"({b_by})")
    r = results.setdefault(name, dict(err=0.0, ms=0.0, event=0.0,
                                      plain=0.0, lib=0.0, t_bytes=0.0,
                                      t_ops=0.0, has_lib=l_ms is not None))
    r["err"] = max(r["err"], err)
    r["ms"] += calls * k_ms
    r["event"] += calls * k_ev
    r["plain"] += calls * p_ms
    r["lib"] += calls * (l_ms or 0.0)
    r["t_bytes"] += calls * terms[0]
    r["t_ops"] += calls * terms[1]


def same_bits(a, b):
    """Whether two outputs (or tuples of them) are equal bit for bit."""
    import torch
    a, b = (a, b) if isinstance(a, tuple) else ((a,), (b,))
    return all(torch.equal(x, y) for x, y in zip(a, b))


def check_kernels(shapes, sa_mod, gen, dev, phase, timing=True):
    """Every model kernel against its plain version at every shape in
    `shapes`, timed if `timing`; slot attention and GN also called twice
    on the same inputs, which must give the same bits (neither sums with
    atomics). -> {kernel: totals over those calls} ({} without `timing`).
    Raises SystemExit if any disagrees."""
    results, failed = {}, []
    for name, calls, label, kern, plain, lib, terms in kernel_cases(
            shapes, sa_mod, gen, dev):
        out = kern()
        if name in DETERMINISTIC:
            same = same_bits(out, kern())
            log(f"{phase}: {name} {label}: two calls on the same inputs "
                f"{'are bit-identical' if same else 'DIFFER'}")
            if not same:
                failed.append(f"{name} {label} not deterministic")
        err = max_err(out, plain())
        if timing:
            record(results, failed, phase, name, calls, label, err,
                   TOL[name], timed(kern), timed(plain),
                   None if lib is None else timed(lib), terms)
            continue
        ok = err <= TOL[name]
        log(f"{phase}: {name} {label} x{calls}: max_abs_err {err:.3e} (tol "
            f"{TOL[name]:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} {label}")
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")
    for name, r in results.items():
        if r["has_lib"]:
            log(f"{phase}: {name} summed over the calls: kernel "
                f"{r['ms']:.4f} ms, library {r['lib']:.4f} ms (device), "
                f"kernel/library {r['ms'] / r['lib']:.3f}")
    return results


def model_grad_cases(shapes, sa_mod, gen, dev):
    """{kernel: (kernel path, plain path, inputs)} for each model kernel at
    its largest shape in `shapes`; the plain path is the function its
    autograd.Function's backward differentiates."""
    import torch
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    (gshape, gact, geps, gG) = max(shapes["gn_silu"],
                                   key=lambda key: key[0][1])
    C = gshape[1]
    (Bs, N, S, D, M, iters, _) = max(shapes["slot_attention"])
    (Bq, nq, nk, heads) = max(shapes["attention"])
    hd = heads * attention_kernel.HEAD_DIM
    sa_keys = slot_attention_kernel.SA_WEIGHT_KEYS
    p = sa_mod.kernel_weights()
    sa_kw = dict(num_iterations=iters, eps=sa_mod.eps)
    rand = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return {
        "gn_silu": (
            lambda x, w, b: fused_norm.fused_group_norm(x, w, b, gG, geps,
                                                        gact),
            lambda x, w, b: fused_norm.group_norm_reference(
                x, w, b, gG, geps, gact),
            [rand(*gshape), 1 + 0.1 * rand(C), 0.1 * rand(C)]),
        "attention": (
            lambda q, k, v: attention_kernel.fused_mha(q, k, v, heads),
            lambda q, k, v: attention_kernel.mha_reference(q, k, v, heads),
            [rand(Bq, n, hd) for n in (nq, nk, nk)]),
        "slot_attention": (
            lambda k, v, s0, *w: slot_attention_kernel.sa_iterations(
                k, v, s0, dict(zip(sa_keys, w)), **sa_kw),
            lambda k, v, s0, *w: slot_attention_kernel.sa_iterations_ref(
                k, v, s0, dict(zip(sa_keys, w)), kv_dtype=torch.float32,
                **sa_kw),
            [rand(Bs, N, D), rand(Bs, N, D), rand(Bs, S, D)] +
            [p[key].detach().contiguous() for key in sa_keys]),
    }


def check_grads(cases, gen, dev, phase):
    """For each (kernel path, plain path, inputs) of `cases`: the gradients
    of a random projection of the output through both paths agree within
    GRAD_TOL of the largest, and the kernel path's are non-zero. Raises
    SystemExit otherwise."""
    import torch

    def grads_of(fn, inputs, proj):
        leaves = [t.detach().clone().requires_grad_() for t in inputs]
        out = fn(*leaves)
        out = out[0] if isinstance(out, tuple) else out
        return torch.autograd.grad((out.float() * proj).sum(), leaves)

    failed = []
    for name, (kern_fn, plain_fn, inputs) in cases.items():
        with torch.no_grad():
            out_shape = plain_fn(*inputs).shape
        proj = torch.randn(out_shape, generator=gen, device=dev)
        gk = grads_of(kern_fn, inputs, proj)
        gp = grads_of(plain_fn, inputs, proj)
        scale = max(g.abs().max().item() for g in gp)
        rel = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(gk, gp)) / scale
        zero = [i for i, g in enumerate(gk) if not g.abs().max() > 0]
        ok = rel <= GRAD_TOL[name] and not zero
        log(f"{phase}: {name} gradients at {tuple(inputs[0].shape)}, "
            f"kernel path vs plain path: max err {rel:.2e} of the largest "
            f"gradient {scale:.2e} (tol {GRAD_TOL[name]:.0e}); zero "
            f"gradients at inputs {zero} {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} gradients")
    if failed:
        raise SystemExit(f"gradients of the kernel paths are wrong: "
                         f"{failed}")


@contextlib.contextmanager
def plain_versions(f32_slot_attention):
    """Within the block the model's three kernel call sites take their
    plain versions: GN and attention their f32 formulas, slot attention
    its plain twin with bf16 k/v (the function phase 3 holds the kernel
    against) or, with `f32_slot_attention`, the f32 formula (the JAX
    model's own off-TPU computation). Raises SystemExit if a kernel
    launches in the block."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.models import blocks, slot_attention, unet
    from slotdiffusion_tpu_torch.ops import (attention_kernel, fused_norm,
                                             slot_attention_kernel)
    sa_ref = slot_attention_kernel.sa_iterations_ref
    plain = {
        (blocks, "fused_group_norm"): fused_norm.group_norm_reference,
        (unet, "fused_mha"): attention_kernel.mha_reference,
        (slot_attention, "sa_iterations"):
            (lambda *a, kv_dtype=None, **kw: sa_ref(
                *a, kv_dtype=torch.float32, **kw))
            if f32_slot_attention else sa_ref}
    saved = {key: getattr(*key) for key in plain}
    try:
        for (mod, attr), fn in plain.items():
            setattr(mod, attr, fn)
        ops.reset_launch_counts()
        yield
        torch.cuda.synchronize()
        if any(launch_counts().values()):
            raise SystemExit("the plain path launched a kernel")
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)


class StepReport:
    """A trainer's logger: per step, the kernels' launches since the last
    reset (then reset), the peak memory and the metrics; a validation's
    record (the one `fit` runs when `max_steps` caps it, where the data
    has a validation set) goes to `val` with its launches."""

    def __init__(self, phase):
        self.phase = phase
        self.steps = []
        self.val = []

    def log(self, record, step):
        import torch
        from slotdiffusion_tpu_torch import ops
        torch.cuda.synchronize()
        counts = launch_counts()
        ops.reset_launch_counts()
        peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
        if "step_seconds" not in record:
            self.val.append(dict(record, launches=counts))
            log(f"{self.phase}: validate at step {step}: " + ", ".join(
                f"{k} {v:.6f}" for k, v in record.items()) +
                f", launches {counts}")
            return
        self.steps.append(dict(record, launches=counts))
        loss = next(k for k in record if k.endswith("_loss") and
                    k != "train/total_loss")
        log(f"{self.phase}: step {step}: {loss.removeprefix('train/')} "
            f"{record[loss]:.5f}, grad norm "
            f"{record.get('train/grad_norm', float('nan')):.4g}, lr "
            f"{record.get('lr', float('nan')):.3g}, "
            f"{record['step_seconds']:.3f} s (host clock), max "
            f"allocated {peak:.2f} GiB, launches {counts}")


def two_clip_grads(model, cfg, dev, tol, phase, f32_slot_attention=True):
    """One 2-clip step's gradients through the kernels and through the
    plain versions (`plain_versions`: by default slot attention's f32
    formula, the JAX model's own off-TPU computation), the same generator
    state, dropout off (eval mode): each parameter's largest error
    relative to its largest gradient (or a hundredth of the model's
    largest, where a gradient is zero in exact arithmetic) within `tol`.
    Raises SystemExit otherwise."""
    import torch
    T, (H, W) = cfg.n_sample_frames, cfg.resolution

    def step_grads():
        model.eval()
        model.zero_grad(set_to_none=True)
        g = torch.Generator(device=dev).manual_seed(7)
        img = torch.rand(2, T, H, W, 3, generator=g, device=dev) * 2 - 1
        _, losses = model.compute_losses({"img": img}, g)
        losses["denoise_loss"].backward()
        return losses["denoise_loss"].item(), {
            n: p.grad.clone() for n, p in model.named_parameters()
            if p.requires_grad}

    loss_k, grads_k = step_grads()
    with plain_versions(f32_slot_attention):
        loss_p, grads_p = step_grads()
    model.zero_grad(set_to_none=True)
    floor = 1e-2 * max(g.abs().max().item() for g in grads_p.values())
    worst = max((((grads_k[n] - g).abs().max() /
                  max(g.abs().max().item(), floor)).item(), n)
                for n, g in grads_p.items())
    log(f"{phase}: 2-clip step, kernels vs plain versions: loss "
        f"{loss_k:.6f} vs {loss_p:.6f}; largest gradient error {worst[0]:.2e}"
        f" of its parameter's scale at {worst[1]} (tol {tol:.0e})")
    if not worst[0] <= tol:
        raise SystemExit("training gradients through the kernels disagree "
                         "with the plain versions'")


def path_kernels(bf16):
    """The kernels a model of the dtype must launch: GN's and attention's
    entry of that dtype, and slot attention's kernel."""
    return BF16_KERNELS if bf16 else MODEL_KERNELS


def check_launches(counts, what, bf16, need=None):
    """`counts` went through each kernel of `need` (by default all of
    `path_kernels(bf16)`) and never through GN's or attention's entry of
    the other dtype. Raises SystemExit otherwise."""
    need = path_kernels(bf16) if need is None else need
    other = path_kernels(not bf16)[:2]
    idle = [k for k in need if counts[k] == 0]
    wrong = [k for k in other if counts[k]]
    if idle or wrong:
        raise SystemExit(f"{what} launched none of {idle}, or the other "
                         f"dtype's entries {wrong}: {counts}")


def serving_inputs(cfg, dev):
    """The serving requests' inputs, from a seeded generator: 2 videos of
    the clip's frames, a noisy latent per frame and its timestep."""
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    B, T, (H, W) = 2, cfg.n_sample_frames, cfg.resolution
    h, w = cfg.dec_dict["resolution"]
    return (torch.rand(B, T, H, W, 3, generator=g, device=dev) * 2 - 1,
            torch.randn(B * T, h, w, 3, generator=g, device=dev),
            torch.full((B * T,), 500.0, device=dev))


def serve(cfg, model, inputs, phase, f32_seconds=None):
    """The serving path of the built `model` through the port's entry
    points: one `encode`, `sample` and `denoise` request on `inputs`
    (`serving_inputs`), each with the launch counts set to 0 just before
    it and read just after. Checks each output's shape, dtype (slots in
    the compute dtype, the rest f32) and finiteness, that the masks sum
    to 1 over the slots and that each request launched its kernels
    (`check_launches`: encode slot attention, sample and denoise GN and
    attention). -> ({request: {kernel: launches}}, {request: host
    seconds}, slots)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    video, x_t, t_model = inputs
    B, T, (H, W) = *video.shape[:2], cfg.resolution
    S, D = cfg.slot_dict["num_slots"], cfg.slot_dict["slot_size"]
    f32 = torch.float32
    want = {"slots": ((B, T, S, D), torch.bfloat16 if cfg.use_bf16 else f32),
            "masks": ((B, T, S, H, W), f32),
            "sample": ((B, T, H, W, 3), f32),
            "denoise": (tuple(x_t.shape), f32)}
    encode, sample, denoise = (build_serving_fn(model, s, graphed=False)
                               for s in ("encode", "sample", "denoise"))
    kernels = path_kernels(cfg.use_bf16)
    per_surface, seconds, slots = {}, {}, None
    for name, fn in (("encode", lambda: encode(video)),
                     ("sample", lambda: sample(0, slots)),
                     ("denoise", lambda: denoise(x_t, t_model, slots))):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        seconds[name] = time.time() - t0
        per_surface[name] = counts = launch_counts()
        outs = dict(zip(("slots", "masks"), out)) if name == "encode" \
            else {name: out}
        log(f"{phase}: {name} in {seconds[name]:.2f}s" + (
            f" (f32, phase 4: {f32_seconds[name]:.2f}s)" if f32_seconds
            else "") + " -> " + ", ".join(
                f"{k} {tuple(v.shape)} {v.dtype}" for k, v in outs.items())
            + f"; launches {counts}")
        for k, v in outs.items():
            if (tuple(v.shape), v.dtype) != want[k] or \
                    not torch.isfinite(v.float()).all():
                raise SystemExit(f"{phase}: {name}: {k} is {v.dtype} "
                                 f"{tuple(v.shape)}, not {want[k]}, or "
                                 "has non-finite values")
        if name == "encode":
            slots = outs["slots"]
            msum = (outs["masks"].sum(2) - 1).abs().max().item()
            if msum > 1e-4:
                raise SystemExit(f"{phase}: masks do not sum to 1 over "
                                 f"the slots ({msum:.2e})")
        check_launches(counts, f"{phase}: {name}", cfg.use_bf16,
                       kernels[2:] if name == "encode" else kernels[:2])
    return per_surface, seconds, slots


def train(cfg, model, dev, gen, phase, f32_step_seconds=None):
    """Phases 5 and 7: hold the kernels of the model's dtype against their
    plain versions at the shapes of a training step, then train the built
    flagship `model` through the port's entry points; -> ({kernel:
    launches} over the Trainer's steps, {kernel: totals over one step's
    forward calls}, the host seconds of each Trainer step)."""
    import gc
    import tempfile

    import torch
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method

    T, (H, W) = cfg.n_sample_frames, cfg.resolution
    model.dm_decoder.vae.requires_grad_(False)
    shapes, handles = record_shapes(model)
    batch, _ = batch_that_fits(
        model, lambda bs: torch.rand(bs, T, H, W, 3, device=dev) * 2 - 1,
        TRAIN_BATCHES, phase, shapes, unit="clips")
    for hk in handles:
        hk.remove()
    cut = "" if batch == cfg.train_batch_size else \
        f" (cut from the config's {cfg.train_batch_size})"
    log(f"{phase}: training at {batch} clips x {T} frames a step{cut}")

    # the kernels and their gradients at this training step's shapes
    sa_mod = model.savi.slot_attention
    if cfg.use_bf16:
        train_results = check_bf16_kernels(shapes, gen, dev,
                                           f"{phase} (training shapes)")
    else:
        train_results = check_kernels(shapes, sa_mod, gen, dev, phase)
        check_grads(model_grad_cases(shapes, sa_mod, gen, dev), gen, dev,
                    phase)
    gc.collect()
    torch.cuda.empty_cache()

    # a log line every step; ckpt_last once per epoch of 4 steps (the
    # config's 0.1 of an epoch would write it after every step here)
    tcfg = cfg.copy(print_iter=1, save_interval=1.0, save_epoch_end=False)
    data = SyntheticVideoData(tcfg, batch, num_samples=4 * batch, seed=0)
    trainable = [p for p in model.parameters() if p.requires_grad]
    with tempfile.TemporaryDirectory() as tmp:
        trainer, report, totals, steps, _ = fit_checked(
            model, tcfg, data, phase, TRAIN_STEPS, cfg.use_bf16,
            ckp_path=os.path.join(tmp, "run"), unit="clips",
            f32_secs=f32_step_seconds)
        # master weights and Adam's moments stay f32 in either dtype
        moments = [v for st in trainer.optimizer.core.state.values()
                   for v in st.values() if torch.is_tensor(v) and v.dim()]
        if any(p.dtype != torch.float32 for p in trainable) or \
                not moments or \
                any(v.dtype != torch.float32 for v in moments):
            raise SystemExit("a parameter or an Adam moment is not f32")
        log(f"{phase}: the trainable tensors and Adam's moments are f32")
        del moments
        ckpt = os.path.join(tmp, "run", "ckpt_last.pt")
        del trainer
        gc.collect()
        # no checkpoint directory: the resumed run writes no second file
        resumed = build_method(model, data, tcfg)
        resumed.logger = report
        last = resumed.fit(max_steps=TRAIN_STEPS + 1, resume_from=ckpt,
                           san_check_val_step=0)
        if resumed.step != TRAIN_STEPS + 1 or \
                not math.isfinite(last["train/denoise_loss"]):
            raise SystemExit(f"resume from {ckpt} failed: {last}")
        for k, n in report.steps[-1]["launches"].items():
            totals[k] += n
        size = os.path.getsize(ckpt) / 2.0 ** 30
        log(f"{phase}: resumed from ckpt_last ({size:.2f} GiB) at step "
            f"{TRAIN_STEPS}, took step {resumed.step}")
        del resumed
    gc.collect()
    torch.cuda.empty_cache()

    # one 2-clip step's gradients through the kernels and through the plain
    # versions, the same generator state, dropout off (eval mode); in f32
    # slot attention's plain version is the JAX model's own off-TPU
    # computation (f32), in bf16 its twin with bf16 k/v: there the f32
    # formula's slots would move every rounding behind them
    if cfg.use_bf16:
        two_clip_grads(model, cfg, dev, BF16_TRAIN_GRAD_TOL, phase,
                       f32_slot_attention=False)
    else:
        two_clip_grads(model, cfg, dev, TRAIN_GRAD_TOL, phase)
    return totals, train_results, steps


def validate_against_plain(ecfg, model, data, dev, gen, smi, phase, what,
                           plain=True, dual=False):
    """`Trainer.validate` of `model` on `data`'s val set with the settings
    `ecfg` (the EMA on: its shadow moved by 1e-3 relative, seeded, so that
    the EMA pass computes something else), through the kernels: every
    loss and metric present and finite, ARI in [-1, 1], the kernels of
    the model's dtype launched, the live weights bit-identical after it.
    With `plain`, the same batches and draws through the plain versions
    (slot attention's bf16 twin): the argmax over the slots (axis -3 of
    the masks, a video's or an image's) must agree wherever the plain
    path's two largest masks are more than ARGMAX_TIE apart and at
    ARGMAX_EXACT of all pixels, the masks within TOL, each metric within
    SEG_METRIC_TOL and each loss within LOSS_RTOL. With `dual` (COCO,
    VOC) the metrics are the `inst/*` and `sem/*` pairs. -> the kernels'
    launches. Raises SystemExit otherwise."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.methods.build import (build_method,
                                                       seg_metrics_fn)
    from slotdiffusion_tpu_torch.models import is_video
    bf16 = ecfg.use_bf16
    trainer = build_method(model, data, ecfg)
    with torch.no_grad():
        for sh in trainer.ema.shadow.values():
            sh.mul_(1 + 1e-3 * torch.randn(sh.shape, generator=gen,
                                           device=dev))
    captured = []

    def capture(batch, out):
        captured.append(out["masks"].clone())
        return seg_metrics_fn(batch, out)

    trainer.host_metrics_fn = capture
    live = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    res_k = trainer.validate()
    torch.cuda.synchronize()
    val_s = time.time() - t0
    counts = launch_counts()
    n_batches = len(captured)
    log(f"{phase}: Trainer.validate over {what}, EMA on: {val_s:.3f} s wall "
        f"({val_s / n_batches:.3f} s a batch, host metrics included) on "
        f"{smi}; launches {counts}")
    log(f"{phase}: " + ", ".join(f"{k} {v:.6f}" for k, v in res_k.items()))
    prefixes = ("inst/", "sem/") if dual else ("",)
    want = {f"val/{k}" for k in ("denoise_loss", "denoise_loss_ema")} | {
        f"val/{p}{k}" for p in prefixes
        for k in ("ari", "fari", "miou", "fmiou", "mbo")}
    if set(res_k) != want or not all(map(math.isfinite, res_k.values())):
        raise SystemExit(f"validate gave {res_k}")
    if not all(-1.0 <= res_k[f"val/{p}{k}"] <= 1.0 for p in prefixes
               for k in ("ari", "fari")):
        raise SystemExit(f"ARI outside [-1, 1]: {res_k}")
    check_launches(counts, f"{phase}: validate", bf16)
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, live[k])]
    if moved:
        raise SystemExit(f"validate left {len(moved)} tensors changed, "
                         f"e.g. {moved[:3]}")
    log(f"{phase}: the live state_dict is bit-identical after validate "
        "(the EMA swap restored it)")
    if not plain:
        return counts

    kernel_masks, captured[:] = list(captured), []
    with plain_versions(f32_slot_attention=False):
        res_p = trainer.validate()
    plain_masks = list(captured)
    # per frame: a video's masks [B, T, S, H, W], an image's [B, S, H, W]
    frames = kernel_masks[0].shape[1] if is_video(type(model).__name__) \
        else 1
    same_t = torch.zeros(frames, device=dev)
    n_px = n_tie = n_miss = 0
    for km, pm in zip(kernel_masks, plain_masks):
        same = km.argmax(-3) == pm.argmax(-3)
        top2 = pm.topk(2, dim=-3).values
        clear = top2.select(-3, 0) - top2.select(-3, 1) > ARGMAX_TIE
        same_t += same.reshape(same.shape[0], frames, -1).float().sum((0, 2))
        n_px += same.numel()
        n_tie += (~clear).sum().item()
        n_miss += (clear & ~same).sum().item()
    same_t /= n_px // frames
    exact = same_t.mean().item()
    mdiff = max((a - b).abs().max().item()
                for a, b in zip(kernel_masks, plain_masks))
    slots = kernel_masks[0].shape[-3]
    ok = exact >= ARGMAX_EXACT and n_miss == 0 and \
        mdiff <= TOL["slot_attention"]
    log(f"{phase}: kernels vs plain versions: the argmax of {slots} slots "
        f"agrees at {exact:.6f} (>= {ARGMAX_EXACT}) of the {n_px} pixels" +
        (" (per frame " + " ".join(f"{a:.6f}" for a in same_t.tolist()) +
         ")" if frames > 1 else "") + f"; {n_tie} pixels "
        f"({n_tie / n_px:.6f}) have their two largest plain masks within "
        f"{ARGMAX_TIE:g} and are left out as ties; of the other "
        f"{n_px - n_tie}, {n_miss} disagree (must be 0); largest mask "
        f"difference {mdiff:.3e} (tol {TOL['slot_attention']:.0e}) "
        f"{'ok' if ok else 'FAIL'}")
    failed = [] if ok else ["argmax agreement"]
    for k in sorted(res_k):
        diff = abs(res_k[k] - res_p[k])
        if "loss" in k:
            tol, what = LOSS_RTOL * abs(res_p[k]), "relative 1e-3"
        else:
            tol, what = SEG_METRIC_TOL, f"{SEG_METRIC_TOL:g}"
        good = diff <= tol
        log(f"{phase}: {k} kernels {res_k[k]:.6f} plain {res_p[k]:.6f} "
            f"diff {diff:.3e} (tol {what}) {'ok' if good else 'FAIL'}")
        if not good:
            failed.append(k)
    if failed:
        raise SystemExit(f"the eval path's kernels disagree with the plain "
                         f"versions: {failed}")
    return counts


def evaluate(cfg, model, dev, gen, smi, phase):
    """Phases 6 and 7: the evaluation path of the built flagship `model`;
    -> ({path: {kernel: launches}}, {kernel: totals} of slot attention at
    the res64 model's shape). In bf16 (phase 7) `Trainer.validate` alone:
    the bf16 model's plain-version check is `bf16_vs_plain`, and the
    chunked video, test_recon and the res64 shape run in f32 only."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.data.synthetic import (SyntheticVideoData,
                                                        SyntheticVideoDataset)
    from slotdiffusion_tpu_torch.methods.build import seg_metrics_fn
    from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
    from slotdiffusion_tpu_torch.models import init_random_
    from slotdiffusion_tpu_torch.models.slot_attention import SlotAttention
    from slotdiffusion_tpu_torch.ops import metrics as M

    per_path = {}
    B, T = EVAL_BATCH, cfg.n_sample_frames
    ecfg = cfg.copy(use_ema=True, val_batch_size=B)
    data = SyntheticVideoData(ecfg, B, num_samples=B, seed=0,
                              val_samples=EVAL_BATCHES * B)
    key = "bf16_validate" if cfg.use_bf16 else "validate"
    per_path[key] = validate_against_plain(
        ecfg, model, data, dev, gen, smi, phase,
        f"{EVAL_BATCHES} batches of {B} synthetic {cfg.resolution[0]}x"
        f"{cfg.resolution[1]} clips x {T} frames",
        plain=not cfg.use_bf16)
    if cfg.use_bf16:
        return per_path, {}
    del data
    gc.collect()
    torch.cuda.empty_cache()

    # 3. test_seg's full-video path: 12 frames in chunks of the clip length
    clip = cfg.n_sample_frames
    vid = SyntheticVideoDataset(resolution=cfg.resolution, num_samples=1,
                                n_sample_frames=2 * clip, seed=2)[0]
    img = torch.from_numpy(vid["img"])[None].to(dev)
    apply = lambda x, prev: model({"img": x}, prev_slots=prev)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = chunked_video_apply(apply, img, clip, keys=("slots", "masks"))
        torch.cuda.synchronize()
        per_path["test_seg"] = launch_counts()
        carried = apply(img[:, clip:], out["slots"][:, clip - 1])["slots"]
        fresh = apply(img[:, clip:], None)["slots"]
    seg = seg_metrics_fn({"masks": torch.from_numpy(vid["masks"])[None]},
                         out)
    S = cfg.slot_dict["num_slots"]
    shapes_ok = out["slots"].shape[:3] == (1, 2 * clip, S) and \
        out["masks"].shape == (1, 2 * clip, S, *cfg.resolution)
    carry_ok = torch.allclose(out["slots"][:, clip:], carried, rtol=1e-5,
                              atol=1e-5) and \
        (out["slots"][:, clip:] - fresh).abs().max().item() > 1e-3
    log(f"phase 6: test_seg full video of {2 * clip} frames in chunks of "
        f"{clip}: slots {tuple(out['slots'].shape)}, masks "
        f"{tuple(out['masks'].shape)}, the second chunk continues the "
        f"first's slots {'ok' if carry_ok else 'FAIL'}; " + ", ".join(
            f"{k} {v:.4f}" for k, v in seg.items()) +
        f"; launches {per_path['test_seg']}")
    if not (shapes_ok and carry_ok and
            all(map(math.isfinite, seg.values()))):
        raise SystemExit("the chunked full-video path failed")

    # 4. test_recon's batch: encode, 20 DPM-Solver++ steps, VQ decode
    vbatch = SyntheticVideoDataset(resolution=cfg.resolution,
                                   num_samples=B, n_sample_frames=T,
                                   seed=1)
    img = torch.stack([torch.from_numpy(vbatch[i]["img"])
                       for i in range(B)]).to(dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        samples = model.log_images(
            {"img": img}, torch.Generator(device=dev).manual_seed(0),
            use_dpm=True, same_noise=True)["samples"]
        torch.cuda.synchronize()
        rec_s = time.time() - t0
        per_path["test_recon"] = launch_counts()
    x = (samples * 0.5 + 0.5).clamp(0, 1).flatten(0, 1)
    y = (img * 0.5 + 0.5).clamp(0, 1).flatten(0, 1)
    rec = {"mse": M.mse_metric(x, y), "psnr": M.psnr_metric(x, y),
           "ssim": M.ssim_metric(x, y)}
    log(f"phase 6: test_recon batch of {B} clips x {T} frames (20 "
        f"DPM-Solver++ steps, VQ decode): {rec_s:.3f} s wall on {smi}; " +
        ", ".join(f"{k} {v:.4f}" for k, v in rec.items()) +
        f"; launches {per_path['test_recon']}")
    if samples.shape != img.shape or \
            not all(map(math.isfinite, rec.values())):
        raise SystemExit(f"test_recon: samples {tuple(samples.shape)}, "
                         f"metrics {rec}")
    del samples, x, y, img

    # 5. slot attention at the res64 model's shape
    sa64 = SlotAttention(in_features=64, num_iterations=2, slot_size=64,
                         mlp_hidden_size=128, return_last_attn=True).to(dev)
    init_random_(sa64, torch.Generator().manual_seed(3))
    res64 = check_kernels(
        {"gn_silu": {}, "attention": {},
         "slot_attention": {(EVAL_BATCH, 4096, 6, 64, 128, 2, True): 1}},
        sa64, gen, dev, "phase 6 (res64 shape)")
    gc.collect()
    torch.cuda.empty_cache()
    return per_path, res64


def kernel_cases_bf16(shapes, gen, dev):
    """The bf16 entry points of GN and attention at each call shape in
    `shapes` (from `record_shapes` on the bf16 model), on random bf16
    inputs: the same tuples as `kernel_cases`. The library calls are
    `F.group_norm` (+ `F.silu`) with the affine in bf16 and SDPA, both in
    bf16; bytes at 2 a value."""
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import attention_kernel, fused_norm
    bf16 = torch.bfloat16
    for (shape, act, eps, G), calls in sorted(shapes["gn_silu"].items(),
                                              key=lambda kv: str(kv[0])):
        C = shape[1]
        xg = (torch.randn(shape, generator=gen, device=dev) * 2 +
              0.5).to(bf16)
        wg = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        bg = 0.1 * torch.randn(C, generator=gen, device=dev)
        wl, bl = wg.to(bf16), bg.to(bf16)
        n = xg.numel()
        yield ("gn_silu_bf16", calls,
               f"{tuple(shape)} act={act} eps={eps:g}",
               lambda: fused_norm.fused_group_norm(xg, wg, bg, G, eps, act),
               lambda: fused_norm.group_norm_reference(xg, wg, bg, G, eps,
                                                       act),
               (lambda: F.silu(F.group_norm(xg, G, wl, bl, eps)))
               if act == "silu" else
               (lambda: F.group_norm(xg, G, wl, bl, eps)),
               bound_terms(2 * n * 2 + 2 * C * 4,
                           f32_ops=(10 if act else 6) * n))
    for (Bq, nq, nk, heads), calls in sorted(shapes["attention"].items()):
        hd = heads * attention_kernel.HEAD_DIM
        q, k, v = (torch.randn(Bq, n, hd, generator=gen, device=dev).to(bf16)
                   for n in (nq, nk, nk))
        split = lambda t: t.view(Bq, t.shape[1], heads, -1).transpose(1, 2)
        yield ("attention_bf16", calls, f"B={Bq} Nq={nq} Nk={nk} H={heads}",
               lambda: attention_kernel.fused_mha(q, k, v, heads),
               lambda: attention_kernel.mha_reference(q, k, v, heads),
               lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                      split(v)),
               # q k^T and w v on the bf16 tensor cores
               bound_terms(2 * (2 * q.numel() + 2 * k.numel()),
                           bf16_ops=4.0 * Bq * nq * nk * hd))


def check_bf16_kernels(shapes, gen, dev, phase):
    """Each bf16 entry point against its plain twin at every shape in
    `shapes`, timed, and called twice on the same inputs (the same bits).
    -> {kernel: totals over those calls}. Raises SystemExit if any
    disagrees."""
    results, failed = {}, []
    for name, calls, label, kern, plain, lib, terms in kernel_cases_bf16(
            shapes, gen, dev):
        out, ref = kern(), plain()
        same = same_bits(out, kern())
        log(f"{phase}: {name} {label}: two calls on the same inputs "
            f"{'are bit-identical' if same else 'DIFFER'}")
        if not same or out.dtype != ref.dtype:
            failed.append(f"{name} {label} not deterministic or not bf16")
        tol = BF16_TOL[name] * ref.float().abs().max().item()
        record(results, failed, phase, name, calls, label,
               max_err(out, ref), tol, timed(kern), timed(plain),
               timed(lib), terms)
    if failed:
        raise SystemExit(f"bf16 kernels disagree with their plain twins: "
                         f"{failed}")
    return results


def bf16_vs_plain(model, inputs, slots):
    """The bf16 `model`'s denoise of 2 frames and encode of one 2-frame
    clip through the kernels against the same through their plain twins
    (slot attention's with bf16 k/v), on the card, within
    BF16_PATH_TOL of each output's largest magnitude. Raises SystemExit
    otherwise."""
    import torch
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    video, x_t, t_model = inputs
    encode, denoise = (build_serving_fn(model, s, graphed=False)
                       for s in ("encode", "denoise"))
    with torch.inference_mode():
        runs = {}
        for how in ("kernels", "plain"):
            ctx = plain_versions(f32_slot_attention=False) \
                if how == "plain" else contextlib.nullcontext()
            with ctx:
                runs[how] = (denoise(x_t[:2], t_model[:2], slots[:1, :2]),
                             *encode(video[:1, :2]))
    for name, a, b in zip(("denoise", "encode slots", "encode masks"),
                          runs["kernels"], runs["plain"]):
        a, b = a.float(), b.float()
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"phase 7: bf16 {name}, kernels vs plain versions on the card: "
            f"max rel err {rel:.2e} (tol {BF16_PATH_TOL:.0e})")
        if not rel <= BF16_PATH_TOL:
            raise SystemExit(f"bf16 {name}: kernels disagree with the "
                             "plain versions")


def median_seconds(fn, n=GRAPH_REQUESTS):
    """The host clock's median over `n` calls of `fn`, each ending in a
    device sync; -> (median seconds, last output)."""
    import torch
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return sorted(times)[n // 2], out


def outputs(out):
    return out if isinstance(out, tuple) else (out,)


def launch_counts():
    """`ops.launch_counts()` and the bf16 GN entry's launches by route
    (`fused_norm.route_launches`), as "gn_silu_bf16.<route>", both since
    the last `ops.reset_launch_counts()`."""
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.ops import fused_norm
    return {**ops.launch_counts(), **{
        "gn_silu_bf16." + e.rsplit(".", 1)[1]: n
        for e, n in fused_norm.route_launches.items()}}


def nonzero(counts):
    return {k: n for k, n in counts.items() if n}


def compare(name, a, b, failed):
    """-> the verdict on two outputs of one request: bit-identical or not,
    with the largest difference relative to the output's largest
    magnitude; `failed` gets `name` unless they are the same bits."""
    same = same_bits(a, b) and all(
        x.dtype == y.dtype for x, y in zip(outputs(a), outputs(b)))
    rel = max(((x.float() - y.float()).abs().max() /
               y.float().abs().max().clamp_min(1e-30)).item()
              for x, y in zip(outputs(a), outputs(b)))
    if not same:
        failed.append(name)
    return f"{'bit-identical' if same else 'DIFFER'} (max rel err {rel:.2e})"


def weight_ptrs(module):
    """{name: address} of `module`'s parameters and buffers."""
    return {n: t.data_ptr() for n, t in (*module.named_parameters(),
                                         *module.named_buffers())}


def serve_graphed(cfg, model, inputs, phase, per_path, failed):
    """Phase 8, on the built flagship `model` (f32 or bf16): `encode`,
    `sample` and `denoise` replayed from CUDA graphs against the eager
    path of the same model and seed (bit for bit), each request's launch
    counts against the eager request's, the host seconds of each (median
    of GRAPH_REQUESTS warm requests, the capture timed apart); then each
    surface exported, reloaded and held against the graphed path; then
    the three artifacts behind `serve_model_torch.make_server` on
    127.0.0.1: /health, one /predict each, one malformed request (400).
    Launches go into `per_path`; a disagreement into `failed`."""
    import io
    import tempfile
    import threading
    import urllib.error
    import urllib.request

    import numpy as np
    import torch
    from slotdiffusion_tpu_torch import ops, serving
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts"))
    from serve_model_torch import make_server
    tag = "bf16_" if cfg.use_bf16 else ""
    video, x_t, t_model = inputs
    model.eval()
    live = {what: (serving.build_serving_fn(model, what, graphed=False),
                   serving.build_serving_fn(model, what))
            for what in serving.SURFACES}
    slots = live["encode"][0](video)[0]
    args = {"encode": (video,), "sample": (0, slots),
            "denoise": (x_t, t_model, slots)}
    counts = {}
    for what in serving.SURFACES:
        eager, graphed = live[what]
        e_s, e_out = median_seconds(lambda: eager(*args[what]))
        ops.reset_launch_counts()
        eager(*args[what])
        torch.cuda.synchronize()
        e_counts = launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graphed(*args[what])  # warm-up and capture
        torch.cuda.synchronize()
        cap_s = time.perf_counter() - t0
        g_s, g_out = median_seconds(lambda: graphed(*args[what]))
        ops.reset_launch_counts()
        g_out = graphed(*args[what])
        torch.cuda.synchronize()
        counts[what] = g_counts = launch_counts()
        same = compare(f"{phase}: graphed {what}", g_out, e_out, failed)
        log(f"{phase}: {what} graphed vs eager {same}; host s (median of "
            f"{GRAPH_REQUESTS}): eager {e_s:.4f}, graphed {g_s:.4f} "
            f"(x{e_s / g_s:.2f}), capture {cap_s:.3f}; launches graphed "
            f"{nonzero(g_counts)} eager {nonzero(e_counts)}")
        if g_counts != e_counts:
            failed.append(f"{phase}: graphed {what} launch counts")
        check_launches(g_counts, f"{phase}: graphed {what}", cfg.use_bf16,
                       path_kernels(cfg.use_bf16)[2:] if what == "encode"
                       else path_kernels(cfg.use_bf16)[:2])
    per_path[f"{tag}graphed_serving"] = {
        k: sum(c[k] for c in counts.values()) for k in launch_counts()}
    if not cfg.use_bf16:
        # in-place weight updates are read by the graph; a parameter whose
        # storage moves drops it
        enc_e, enc_g = live["encode"]
        p = next(model.savi.slot_attention.parameters())
        with torch.no_grad():
            p.mul_(1.001)
            same = compare(f"{phase}: graphed encode after an in-place "
                           "update", enc_g(video), enc_e(video), failed)
            p.div_(1.001)
        kept = len(enc_g.program.graphs)
        p.data = p.data.clone()
        dropped = compare(f"{phase}: graphed encode after a storage move",
                          enc_g(video), enc_e(video), failed)
        log(f"{phase}: graphed encode after an in-place weight update "
            f"{same} ({kept} graph kept); after a parameter's storage "
            f"moved, captured again: {dropped}")

    with tempfile.TemporaryDirectory() as tmp:
        loaded = {}
        for what in serving.SURFACES:
            # a client's request: slots in f32, as npz carries them
            fn = live[what][1]
            example = {"encode": (video,),
                       "sample": (np.int32(3), slots.float()),
                       "denoise": (x_t, t_model, slots.float())}[what]
            path = os.path.join(tmp, f"{what}.pt2")
            ptrs, kept = weight_ptrs(fn.module), dict(fn.program.graphs)
            t0 = time.perf_counter()
            header = serving.save_artifact(path, fn, example,
                                           meta={"what": what})
            exp_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            call, _ = serving.load_artifact(path)
            load_s = time.perf_counter() - t0
            # exporting and loading must leave the live model's storage,
            # and so its graphs, where they were
            moved = [n for n, q in weight_ptrs(fn.module).items()
                     if ptrs.get(n) != q]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call(*example)  # warm-up and capture
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ops.reset_launch_counts()
            a_out = call(*example)
            torch.cuda.synchronize()
            a_counts = launch_counts()
            # a client's bf16 `sample`/`denoise` request sends f32 slots,
            # which the graphed requests above did not: one new graph
            fn(*example)
            held = all(fn.program.graphs.get(k) is g for k, g in kept.items())
            new = len(fn.program.graphs) - len(kept)
            fresh = int(cfg.use_bf16 and what != "encode")
            ops.reset_launch_counts()
            g_out = fn(*example)
            torch.cuda.synchronize()
            g_counts = launch_counts()
            same = compare(f"{phase}: {what} artifact", a_out, g_out, failed)
            loaded[what] = (path, example, a_out)
            per_path[f"{tag}artifact_{what}"] = a_counts
            log(f"{phase}: {what} artifact ({len(header['programs'])} "
                f"programs) {os.path.getsize(path) / 1e6:.1f} MB: export "
                f"{exp_s:.2f} s, load {load_s:.2f} s, first call (capture) "
                f"{first_s:.2f} s; reloaded vs graphed {same}; launches "
                f"{nonzero(a_counts)} (graphed {nonzero(g_counts)}); "
                f"export and load moved {len(moved)} of {len(ptrs)} live "
                f"parameters and buffers {moved[:4]}; the graphed surface "
                f"kept its {len(kept)} graph(s): {held}, captured {new} for "
                f"the client's dtypes (expected {fresh})")
            if a_counts != g_counts:
                failed.append(f"{phase}: {what} artifact launch counts")
            if moved or not held or new != fresh:
                failed.append(f"{phase}: {what} export or load moved the "
                              "live model's storage or graphs")
            del call
        # the HTTP surface of each artifact
        ops.reset_launch_counts()
        for what, (path, example, a_out) in loaded.items():
            srv = make_server(path, port=0, host="127.0.0.1")
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            base = f"http://127.0.0.1:{srv.server_port}"
            try:
                health = json.loads(urllib.request.urlopen(
                    f"{base}/health", timeout=60).read())
                arrays = [a.cpu().numpy() if torch.is_tensor(a) else
                          np.asarray(a) for a in example]
                buf = io.BytesIO()
                np.savez(buf, **{f"arg{i}": a for i, a in enumerate(arrays)})
                got = np.load(io.BytesIO(urllib.request.urlopen(
                    urllib.request.Request(f"{base}/predict",
                                           buf.getvalue(), method="POST"),
                    timeout=600).read()))
                want = [o.float().cpu().numpy() for o in outputs(a_out)]
                same = all(np.array_equal(got[f"out{i}"], w)
                           for i, w in enumerate(want))
                bad = io.BytesIO()
                np.savez(bad, **{f"arg{i}": a[:1] if a.ndim else a
                                 for i, a in enumerate(arrays)})
                try:
                    urllib.request.urlopen(urllib.request.Request(
                        f"{base}/predict", bad.getvalue(), method="POST"),
                        timeout=60)
                    code = 200
                except urllib.error.HTTPError as e:
                    code = e.code
            finally:
                srv.shutdown()
                srv.server_close()
                th.join(timeout=60)
            log(f"{phase}: HTTP {what}: /health {health['status']} "
                f"{health['surface']} on {health['device']}; /predict "
                f"{'equals' if same else 'DIFFERS from'} the artifact's "
                f"output; a malformed request -> {code}")
            if not (same and code == 400 and health["status"] == "ok"):
                failed.append(f"{phase}: HTTP {what}")
        torch.cuda.synchronize()
        per_path[f"{tag}http"] = launch_counts()
    log(f"{phase}: launches over the graphed requests "
        f"{nonzero(per_path[f'{tag}graphed_serving'])}, the HTTP requests "
        f"{nonzero(per_path[f'{tag}http'])}")


class VQReport:
    """A stage-1 trainer's logger: per train step, its losses, host
    seconds and the peak memory; the val record apart."""

    def __init__(self, phase, smi):
        self.phase, self.smi = phase, smi
        self.steps, self.val = [], None

    def log(self, record, step):
        import torch
        if "val/recon_loss" in record:
            self.val = record
            log(f"{self.phase}: validate at step {step}: " + ", ".join(
                f"{k} {v:.5f}" for k, v in record.items()))
            return
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
        self.steps.append(dict(record, peak_gib=peak))
        log(f"{self.phase}: step {step}: " + ", ".join(
            f"{k.removeprefix('train/')} {record[k]:.5f}" for k in
            ("train/recon_loss", "train/quant_loss", "train/percept_loss",
             "train/grad_norm") if k in record) +
            f", {record['step_seconds']:.3f} s (host clock), max allocated "
            f"{peak:.2f} GiB [{self.smi}]")


def train_stage1(cfg, dev, tmp, smi, phase):
    """Train the stage-1 VQ-VAE `cfg` (built with `init_reference_`, seed
    0) for STAGE1_STEPS steps through `build_method` -> `Trainer.fit`, on
    synthetic single frames at the config's batch, with one val batch:
    finite losses with `percept_loss` in every step, a non-zero gradient
    on every parameter, parameters that moved, no kernel launched (the
    JAX VQ-VAE runs none); `fit` then validates and writes ckpt_last.pt
    under `tmp`. -> (model, its ckpt_last.pt, step seconds, peak GiB)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_reference_

    model = build_model(cfg, device=dev)
    init_reference_(model, torch.Generator().manual_seed(0))
    B = cfg.train_batch_size
    data = SyntheticVideoData(cfg, B, num_samples=STAGE1_STEPS * B, seed=0,
                              val_samples=cfg.val_batch_size)
    params = list(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params}
    got_grad = {}

    def note_grad(name):
        def hook(p):
            got_grad[name] = got_grad.get(name, False) | bool(
                (p.grad != 0).any())
        return hook

    hooks = [p.register_post_accumulate_grad_hook(note_grad(n))
             for n, p in params]
    # phase 16 draws the epoch-end visualisation: use_viz off here
    trainer = build_method(model, data, cfg.copy(save_epoch_end=False,
                                                 use_viz=False),
                           ckp_path=tmp)
    trainer.logger = report = VQReport(phase, smi)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    trainer.fit(max_steps=STAGE1_STEPS, san_check_val_step=0)
    torch.cuda.synchronize()
    counts = launch_counts()
    log(f"{phase}: Trainer.fit(max_steps={STAGE1_STEPS}) at {B} frames a "
        f"step took {time.time() - t0:.1f}s (host clock; validate and "
        f"ckpt_last included); launches {counts}")
    for hk in hooks:
        hk.remove()
    if any(counts.values()):
        raise SystemExit(f"{phase}: the VQ-VAE launched a kernel: {counts}")
    if len(report.steps) != STAGE1_STEPS or any(
            "train/percept_loss" not in st or not all(
                math.isfinite(st[k]) for k in st if k.startswith("train/"))
            for st in report.steps):
        raise SystemExit(f"{phase}: a step's losses are not finite or lack "
                         f"percept_loss: {report.steps}")
    if report.val is None or "val/percept_loss" not in report.val:
        raise SystemExit(f"{phase}: validate gave {report.val}")
    no_grad = [n for n, _ in params if not got_grad.get(n)]
    still = [n for n, p in params if torch.equal(p, start[n])]
    if no_grad or still:
        raise SystemExit(f"{phase}: {len(no_grad)} parameters got no "
                         f"gradient ({no_grad[:5]}), {len(still)} did not "
                         f"move ({still[:5]})")
    ckpt = os.path.join(tmp, "ckpt_last.pt")
    log(f"{phase}: all {len(params)} parameter tensors got non-zero "
        f"gradients and moved; ckpt_last.pt "
        f"{os.path.getsize(ckpt) / 2 ** 20:.1f} MiB")
    steps = [st["step_seconds"] for st in report.steps]
    return model, ckpt, steps, max(st["peak_gib"] for st in report.steps)


def stage1(smi, dev, gen, phase="phase 9"):
    """Phase 9: the flagship's stage 1 and its handoff. `VQVAEMoviE128` at
    full width trains in f32 and in bf16 (`train_stage1`) with the
    perceptual term live on a seeded random LPIPS npz written by the
    port's `save_random_lpips_npz` and passed explicitly; one batch's
    losses on the card against the same model on the CPU; then the f32
    run's ckpt_last.pt grafted into the flagship SAViDiffusion through
    `vqvae_ckp_path`, whose VQ-VAE must decode a latent bit-identically
    to the stage-1 model, and which serves one `encode` + `sample` (+
    `denoise`) request and takes one training step with the three model
    kernels launched. -> {path: {kernel: launches}}."""
    import gc
    import tempfile

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.ops.lpips import (load_lpips,
                                                   save_random_lpips_npz)
    from slotdiffusion_tpu_torch.training.checkpoint import graft_pretrained

    per_path = {}
    with tempfile.TemporaryDirectory() as tmp:
        npz = save_random_lpips_npz(os.path.join(tmp, "lpips.npz"), seed=0)
        # a log line every step, no checkpoint before the end of the run,
        # one val batch
        cfg = configs.VQVAEMoviE128().copy(
            lpips_weights=npz, print_iter=1, save_interval=1e6,
            val_batch_size=64)
        ed = cfg.enc_dec_dict
        log(f"{phase}: stage 1: VQVAEMoviE128 ({cfg.resolution[0]}x"
            f"{cfg.resolution[1]}, ch {ed['ch']}, ch_mult "
            f"{tuple(ed['ch_mult'])}, {cfg.vq_dict['n_embed']} codes), LPIPS "
            f"live on a seed-0 random npz, {cfg.train_batch_size} frames a "
            "step")
        model, ckpt, f32_steps, f32_peak = train_stage1(
            cfg, dev, os.path.join(tmp, "f32"), smi, f"{phase} (f32)")
        # one batch's losses, the card against the CPU (the plain formulas
        # there, TF32 off here); train=False: no dropout draw to match
        cpu = build_model(cfg, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in
                             model.state_dict().items()})
        img = torch.rand(STAGE1_CPU_FRAMES, 1, *cfg.resolution, 3,
                         generator=gen, device=dev) * 2 - 1
        with torch.no_grad():
            out_d, loss_d = model.compute_losses({"img": img}, train=False)
            out_c, loss_c = cpu.compute_losses({"img": img.cpu()},
                                               train=False)
        agree = (out_d["token_id"].cpu() == out_c["token_id"]).float()
        rel = {k: abs(loss_d[k].item() - v.item()) / abs(v.item())
               for k, v in loss_c.items()}
        log(f"{phase}: {STAGE1_CPU_FRAMES} frames' losses, card vs CPU: " +
            ", ".join(f"{k} {loss_d[k].item():.6f} vs {loss_c[k].item():.6f}"
                      f" (rel {r:.1e})" for k, r in rel.items()) +
            f" (tol {LOSS_RTOL:.0e}); token ids agree at "
            f"{agree.mean().item():.5f}")
        if set(rel) != {"recon_loss", "quant_loss", "percept_loss"} or \
                max(rel.values()) > LOSS_RTOL:
            raise SystemExit(f"{phase}: the card's VQ-VAE losses disagree "
                             f"with the CPU's: {rel}")
        del cpu, out_c
        # the perceptual term's share of a step: LPIPS forward and backward
        # (to the reconstruction) over one step's frames, CUDA events
        x = torch.rand(cfg.train_batch_size, *cfg.resolution, 3,
                       generator=gen, device=dev) * 2 - 1
        y = (x + 0.1 * torch.randn(x.shape, generator=gen, device=dev)
             ).requires_grad_(True)
        net = load_lpips(npz, dev)
        lp_ms = []
        for _ in range(4):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            net(y, x).mean().backward()
            end.record()
            torch.cuda.synchronize()
            lp_ms.append(start.elapsed_time(end))
        lp = sorted(lp_ms[1:])[1]
        log(f"{phase}: LPIPS forward + backward over {cfg.train_batch_size} "
            f"frames: {lp:.1f} ms (median of 3 after a warm-up; CUDA "
            f"events), {lp / 1e3 / statistics.median(f32_steps):.3f} of the "
            f"f32 step's median host seconds [{smi}]")
        del x, y
        stage1_model = model.eval()
        gc.collect()
        torch.cuda.empty_cache()
        model16, _, bf16_steps, bf16_peak = train_stage1(
            cfg.copy(use_bf16=True), dev, os.path.join(tmp, "bf16"), smi,
            f"{phase} (bf16)")
        del model16
        gc.collect()
        torch.cuda.empty_cache()
        log(f"{phase}: VQ-VAE step seconds (host clock) f32 " +
            " ".join(f"{s:.3f}" for s in f32_steps) + ", bf16 " +
            " ".join(f"{s:.3f}" for s in bf16_steps) + f"; peak memory "
            f"f32 {f32_peak:.2f} GiB, bf16 {bf16_peak:.2f} GiB [{smi}]")

        # ---- stage 2: the flagship on the port's own stage-1 checkpoint
        scfg = configs.SAViLDMMoviE128()
        vae = dict(scfg.dec_dict["vae_dict"], vqvae_ckp_path=ckpt)
        scfg = scfg.copy(dec_dict=dict(scfg.dec_dict, vae_dict=vae))
        flagship = build_model(scfg, device=dev)
        init_random_(flagship, torch.Generator().manual_seed(0))
        if not graft_pretrained(flagship, scfg):
            raise SystemExit(f"{phase}: nothing grafted")
        got = flagship.dm_decoder.vae.vqvae.state_dict()
        differ = [k for k, v in stage1_model.state_dict().items()
                  if not torch.equal(got[k], v)]
        z = torch.randn(2, *scfg.dec_dict["resolution"], 3, generator=gen,
                        device=dev)
        with torch.no_grad():
            same = torch.equal(flagship.dm_decoder.vae.decode(
                z, quantize=False), stage1_model.decode(z))
        log(f"{phase}: grafted {ckpt.removeprefix(tmp)} into the flagship: "
            f"{len(got)} tensors, {len(differ)} differ; its VQ-VAE decodes "
            f"a latent {'bit-identically to' if same else 'UNLIKE'} the "
            "stage-1 model")
        if differ or not same:
            raise SystemExit(f"{phase}: the grafted VQ-VAE is not the "
                             f"stage-1 model ({differ[:5]})")
        del stage1_model, model
        per_surface, _, _ = serve(scfg, flagship, serving_inputs(scfg, dev),
                                  f"{phase} (stage 2)")
        per_path["stage2_serving"] = {
            k: sum(c[k] for c in per_surface.values())
            for k in launch_counts()}
        tcfg = scfg.copy(print_iter=1)
        data = SyntheticVideoData(tcfg, STAGE2_CLIPS,
                                  num_samples=STAGE2_CLIPS, seed=0)
        trainer = build_method(flagship, data, tcfg)
        flagship.train()
        batch = next(iter(data.train_loader(0)))
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        metrics = trainer.train_step(batch)
        torch.cuda.synchronize()
        per_path["stage2_training"] = counts = launch_counts()
        log(f"{phase} (stage 2): one training step at {STAGE2_CLIPS} clips: "
            f"denoise_loss {metrics['train/denoise_loss']:.5f}, "
            f"{metrics['step_seconds']:.3f} s; launches {counts}")
        if not math.isfinite(metrics["train/denoise_loss"]):
            raise SystemExit(f"{phase}: stage 2's loss is not finite")
        check_launches(counts, f"{phase} (stage 2): a training step", False)
        del trainer, flagship
    gc.collect()
    torch.cuda.empty_cache()
    return per_path


def short_schedule_config(cfg, timesteps=ANCESTRAL_TIMESTEPS):
    """The flagship with its decoder's schedule over `timesteps` steps
    (the same UNet, the same weights from the same seed)."""
    dec = dict(cfg.dec_dict)
    dec["diffusion_dict"] = dict(dec["diffusion_dict"], timesteps=timesteps)
    return cfg.copy(dec_dict=dec)


def pixel_config(cfg, side=PIXEL_SIDE):
    """The flagship with a pixel-space decoder: its UNet over side x side
    x 3 frames, no VQ-VAE (the JAX `_build_dm_decoder` then builds a
    CondDDPM), clips of side x side."""
    dec = {k: v for k, v in cfg.dec_dict.items() if k != "vae_dict"}
    return cfg.copy(resolution=(side, side),
                    dec_dict=dict(dec, resolution=(side, side)))


@contextlib.contextmanager
def unet_calls(dm, idx):
    """Within the block, each call of `dm`'s UNet is counted and its
    input and output at the frames `idx` recorded (copies on the device,
    no sync). Yields the list of (x, t, context, out)."""
    calls = []

    def hook(_, args, out):
        x, t, ctx = args[:3]
        calls.append((x[idx].clone(), t[idx].clone(),
                      None if ctx is None else ctx[idx].clone(),
                      out[idx].clone()))
    handle = dm.unet.register_forward_hook(hook)
    try:
        yield calls
    finally:
        handle.remove()


@contextlib.contextmanager
def sampled_latents(dm, out):
    """Within the block, every latent the LDM `dm` decodes is appended to
    `out` (the sampler's final x, before the VQ decode)."""
    decode = dm.decode_latent
    dm.decode_latent = lambda z: out.append(z) or decode(z)
    try:
        yield
    finally:
        del dm.decode_latent


def sampler_gate(kind, kw):
    if kind == "bf16":
        return CODE_AGREE["bf16"]
    if kw.get("use_dpm"):
        return PIXEL_TOL["dpm"] if kind == "pixel" else CODE_AGREE["dpm"]
    key = "ddim" if kw.get("use_ddim") else "ancestral"
    return PIXEL_TOL[key] if kind == "pixel" else CODE_AGREE[key]


def final_distance(dm, latent, a, b):
    """Two final samples of the same frames: -> (share of latent
    positions whose VQ code agrees, [frames] whether all of a frame's
    codes agree) for an LDM, or (largest difference over the scale of
    `b`, None) in pixels."""
    if not latent:
        return ((a - b).abs().max() / b.abs().max()).item(), None
    same = (dm.vae.quantize(a) == dm.vae.quantize(b)).all(-1)
    return same.float().mean().item(), same.flatten(1).all(1)


def run_sampler(model, kind, name, kw, twin_frames, video, dev, phase):
    """One `log_images` of `video` through the kernels with the launch
    counts set to 0 just before and read just after (61 GN and 32
    attention a UNet call through the model dtype's entries, 6 slot
    attention), then the checks against the plain versions of GN and
    attention: the end-to-end twin (the same sampler over the kernel
    path's slots at all 12 frames or the first frame of each video, the
    same generator seed) within `sampler_gate`, or, outside it, a chaotic
    chain shown by the control (the kernel path from an x_T moved by
    CONTROL_EPS, outside the gate too); and up to CHECKED_CALLS UNet calls
    of the chain replayed through the plain versions within PER_CALL_TOL.
    -> (launch counts, report dict, failure or None)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.models.diffusion import LDM, noise_like
    dm = model.dm_decoder
    latent = isinstance(dm, LDM)
    B, T = video.shape[:2]
    idx = list(range(B * T)) if twin_frames is None else \
        [i * T for i in range(twin_frames)]
    z = []
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode(), unet_calls(dm, idx) as calls, \
            (sampled_latents(dm, z) if latent else contextlib.nullcontext()):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        start.record()
        out = model.log_images(
            {"img": video}, torch.Generator(device=dev).manual_seed(5), **kw)
        end.record()
        torch.cuda.synchronize()
        wall = time.time() - t0
        counts = launch_counts()
    n_calls = len(calls)
    bf16 = kind == "bf16"
    gn, attn = ("gn_silu_bf16", "attention_bf16") if bf16 else \
        ("gn_silu", "attention")
    want = {gn: GN_PER_UNET * n_calls, attn: ATTN_PER_UNET * n_calls,
            "slot_attention": 6}
    if any(counts[k] != v for k, v in want.items()) or n_calls == 0:
        raise SystemExit(f"{phase}: {kind} {name}: {n_calls} UNet calls "
                         f"launched {nonzero(counts)}, not {want}")
    check_launches(counts, f"{phase}: {kind} {name}", bf16)
    final = (z[0] if latent else out["samples"].flatten(0, 1))[idx]
    cond = out["slots"].reshape(B * T, *out["slots"].shape[2:])[idx]
    frames = out["samples"].flatten(0, 1)[idx].float()
    # the end-to-end twin through the plain versions
    with torch.inference_mode(), plain_versions(True):
        t1 = time.time()
        twin = dm.generate_imgs(torch.Generator(device=dev).manual_seed(5),
                                cond=cond, same_noise=True, **kw)
        torch.cuda.synchronize()
        twin_wall = time.time() - t1
        plain = (dm.decode_latent(twin) if latent else twin).float()
        # the chain call by call: recorded inputs through the plain UNet
        step = max(1, n_calls // CHECKED_CALLS)
        per_call = max(((o - dm.unet(x, t, c)).abs().max() / o.abs().max()
                        ).item() for x, t, c, o in calls[::step])
    del calls
    gate = sampler_gate(kind, kw)
    scale = plain.abs().max().item()
    err_all = (frames - plain).abs().max().item() / scale
    with torch.inference_mode():
        score, whole = final_distance(dm, latent, final, twin)
    inside = score >= gate if latent else score <= gate
    report = {"sampler": name, "model": kind, "unet_calls": n_calls,
              "twin_frames": len(idx), "wall_s": wall,
              "event_ms": start.elapsed_time(end), "twin_wall_s": twin_wall,
              "launches": nonzero(counts), "per_call_err": per_call,
              "frame_err_all": err_all}
    if latent:
        same_err = ((frames[whole] - plain[whole]).abs().max().item() /
                    scale if whole.any() else 0.0)
        inside = inside and same_err <= SAME_CODE_TOL
        report.update(code_agree=score, frames_all_codes_equal=int(
            whole.sum()), same_code_frame_err=same_err)
        verdict = (f"codes agree at {score:.6f} (gate >= {gate}), "
                   f"{int(whole.sum())} of {len(idx)} frames with every "
                   f"code equal, their largest difference {same_err:.2e} "
                   f"(tol {SAME_CODE_TOL:.0e}), all frames {err_all:.2e} of "
                   f"the frame scale {scale:.3g}")
    else:
        verdict = (f"largest frame difference {score:.2e} of the frame "
                   f"scale {scale:.3g} (tol {gate:.0e})")
    chaotic = False
    if not inside:
        # the control: the kernel path again from an x_T one rounding away
        with torch.inference_mode():
            g = torch.Generator(device=dev).manual_seed(5)
            x_T = noise_like(g, (len(idx), *dm.resolution, dm.channels),
                             True, dev) * (1.0 + CONTROL_EPS)
            again = dm.generate_imgs(g, cond=cond, same_noise=True,
                                     x_T=x_T, **kw)
            control, _ = final_distance(dm, latent, again, final)
        chaotic = control < gate if latent else control > gate
        report["control"] = control
        verdict += (f"; outside: the kernel path from x_T x (1 + "
                    f"{CONTROL_EPS:.1e}) against itself "
                    f"{'agrees at' if latent else 'differs by'} "
                    f"{control:.6g}: " + ("a chaotic chain, the end-to-end "
                                         "numbers are not a gate" if chaotic
                                         else "a stable chain"))
    per_tol = PER_CALL_TOL["bf16" if bf16 else "f32"]
    ok = (inside or chaotic) and per_call <= per_tol and \
        bool(torch.isfinite(out["samples"]).all())
    report["ok"] = ok
    log(f"{phase}: {kind} {name}: {n_calls} UNet calls, {wall:.2f} s wall, "
        f"{report['event_ms']:.1f} ms CUDA events, twin over {len(idx)} "
        f"frames {twin_wall:.2f} s; launches {nonzero(counts)}; kernels vs "
        f"plain: {verdict}; {len(range(0, n_calls, step))} calls replayed "
        f"through the plain versions: largest difference {per_call:.2e} of "
        f"the output scale (tol {per_tol:.0e}) {'ok' if ok else 'FAIL'}")
    return counts, report, None if ok else f"{kind} {name}"


def pixel_sample_surface(model, dev, phase, failed):
    """The `sample` serving surface of the pixel-space decoder (20
    DPM-Solver++ steps with dynamic thresholding, no decode) on
    PIXEL_SERVE videos' slots, eagerly and from a CUDA graph: the same
    bits, the same launches (GN_PER_UNET GN and ATTN_PER_UNET attention a
    UNet call, the 49,152-value groups through the GN kernel's two-pass
    path), images of the decoder's side. -> {path: launches}; a fault
    goes to `failed`."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    g = torch.Generator(device=dev).manual_seed(13)
    slots = torch.randn(PIXEL_SERVE, PIXEL_SERVE_FRAMES, model.num_slots,
                        model.slot_size, generator=g, device=dev)
    side = model.dm_decoder.resolution
    paths, outs = {}, {}
    for graphed in (False, True):
        fn = build_serving_fn(model, "sample", graphed=graphed)
        if graphed:
            fn(3, slots)  # the capture
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        with torch.inference_mode():
            out = fn(3, slots)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = launch_counts()
        name = "graphed" if graphed else "eager"
        outs[name] = out
        paths[f"pixel_{name}_sample"] = counts
        calls = counts["gn_silu"] // GN_PER_UNET
        ok = out.shape == (PIXEL_SERVE, PIXEL_SERVE_FRAMES, *side, 3) and \
            bool(torch.isfinite(out).all()) and calls > 0 and \
            counts["gn_silu"] == GN_PER_UNET * calls and \
            counts["attention"] == ATTN_PER_UNET * calls
        verdict = ""
        if graphed:
            same = torch.equal(out, outs["eager"]) and \
                counts == paths["pixel_eager_sample"]
            verdict = "; vs eager " + ("bit-identical, the same launches"
                                       if same else "DIFFERS")
            ok = ok and same
        log(f"{phase}: {name} `sample` surface of the pixel decoder over "
            f"{side[0]}x{side[1]} ({PIXEL_SERVE} x {PIXEL_SERVE_FRAMES} "
            f"frames) in {secs:.3f} s (host clock): {tuple(out.shape)}, "
            f"{calls} UNet calls, launches {nonzero(counts)}{verdict} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"pixel {name} sample surface")
    return paths


def samplers(smi, dev, phase="phase 10"):
    """Every sampler of the decoder at full flagship width (random
    weights, seed 0) through `log_images` of 2 videos x 6 frames, each
    against the plain versions (`run_sampler`; the ancestral chain over
    the first video): DPM-Solver(++) methods,
    DDIM, ancestral, two of them in bf16, and the pixel-space decoder,
    also through its `sample` serving surface, eager and graphed.
    -> {path: launch counts}; raises SystemExit after the last run if any
    failed."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    t0 = time.time()
    base = configs.SAViLDMMoviE128()
    cfgs = {"f32": base, "f32_short": short_schedule_config(base),
            "bf16": base.copy(use_bf16=True), "pixel": pixel_config(base)}
    per_path, reports, failed = {}, [], []
    for kind in cfgs:
        cfg = cfgs[kind]
        model = build_model(cfg, device=dev)
        init_random_(model, torch.Generator().manual_seed(0))
        video = serving_inputs(cfg, dev)[0]
        log(f"{phase}: {kind} model: {cfg.resolution[0]}x"
            f"{cfg.resolution[1]} clips, decoder "
            f"{type(model.dm_decoder).__name__} over "
            f"{cfg.dec_dict['resolution']} x {model.dm_decoder.channels}, "
            f"T = {model.dm_decoder.num_timesteps}")
        total = dict.fromkeys(launch_counts(), 0)
        for name, k, kw, twin in SAMPLER_RUNS:
            if k != kind:
                continue
            # a twin of one frame: the kernel path over one video too
            counts, report, fault = run_sampler(
                model, kind, name, kw, twin,
                video[:1] if twin == 1 else video, dev, phase)
            reports.append(report)
            failed += [fault] if fault else []
            total = {n: total[n] + counts[n] for n in total}
        per_path[f"samplers_{kind}"] = total
        if kind == "pixel":
            per_path.update(pixel_sample_surface(model, dev, phase,
                                                 failed))
        del model
        gc.collect()
        torch.cuda.empty_cache()
    log(f"{phase}: {len(reports)} sampler runs in {time.time() - t0:.1f} s "
        f"on {smi}; launches " + ", ".join(
            f"{p} {nonzero(c)}" for p, c in per_path.items()))
    log(f"{phase}: runs " + json.dumps(reports))
    if failed:
        raise SystemExit(f"{phase}: the kernel path disagrees with the "
                         f"plain versions: {failed}")
    return per_path


def image_inputs(cfg, dev):
    """The image requests' inputs, from a seeded generator: IMG_SERVE
    images, a noisy latent per image and its timestep."""
    import torch
    g = torch.Generator(device=dev).manual_seed(11)
    H, W = cfg.resolution
    h, w = cfg.dec_dict["resolution"]
    return (torch.rand(IMG_SERVE, H, W, 3, generator=g, device=dev) * 2 - 1,
            torch.randn(IMG_SERVE, h, w, 3, generator=g, device=dev),
            torch.full((IMG_SERVE,), 500.0, device=dev))


def batch_that_fits(model, make_img, batches, phase, shapes=None,
                    unit="images"):
    """The first of `batches` whose forward + backward on `make_img(bs)`
    (and Adam's two moments a trainable parameter) fit the card, with its
    peak bytes; `shapes` (from `record_shapes`) then holds that probe's
    kernel calls. Raises SystemExit if none fits."""
    import gc

    import torch
    gib = 2.0 ** 30
    total = torch.cuda.get_device_properties(0).total_memory
    adam = 2 * sum(p.numel() * 4 for p in model.parameters()
                   if p.requires_grad)
    for bs in batches:
        if shapes is not None:
            for calls in shapes.values():
                calls.clear()
        model.train()
        torch.cuda.reset_peak_memory_stats()
        try:
            g = torch.Generator(device=next(model.parameters()).device
                                ).manual_seed(0)
            _, losses = model.compute_losses({"img": make_img(bs)}, g)
            sum(losses.values()).backward()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        except torch.cuda.OutOfMemoryError:
            peak = None
        model.zero_grad(set_to_none=True)
        losses = None
        gc.collect()
        torch.cuda.empty_cache()
        fits = peak is not None and peak + adam + 2 * gib < total
        log(f"{phase}: {bs} {unit} a step: peak "
            f"{'OOM' if peak is None else f'{peak / gib:.2f} GiB'} + Adam "
            f"{adam / gib:.2f} GiB of {total / gib:.1f} GiB -> "
            f"{'fits' if fits else 'does not fit'}")
        if fits:
            return bs, peak
    raise SystemExit(f"{phase}: no training batch fits the card")


def fit_checked(model, tcfg, data, phase, steps, bf16=False, need=None,
                ckp_path=None, unit="images", f32_secs=None, smi=None,
                every_param=True):
    """`build_method` -> `Trainer.fit(max_steps=steps)` on `data` with the
    settings `tcfg`, each step's launch counts read and reset
    (`StepReport`): finite losses, every kernel of `need` (default: the
    dtype's three) launched in every step, and with `every_param` every
    trainable parameter a non-zero gradient and, over more than one step,
    moved (the warmup's first update has LR 0). -> (the trainer, its
    report, {kernel: launches} over the steps, the host seconds of each
    step, the peak GiB)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.methods.build import build_method
    trainable = [(n, p) for n, p in model.named_parameters()
                 if p.requires_grad]
    got = {}

    def note(name):
        def hook(p):
            seen = (p.grad != 0).any()
            got[name] = got[name] | seen if name in got else seen
        return hook

    hooks = [p.register_post_accumulate_grad_hook(note(n))
             for n, p in trainable]
    start = {n: p.detach().clone() for n, p in trainable}
    # phase 16 draws the epoch-end visualisation: use_viz off here
    trainer = build_method(model, data, tcfg.copy(save_epoch_end=False,
                                                  use_viz=False),
                           ckp_path=ckp_path)
    trainer.logger = report = StepReport(phase)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    trainer.fit(max_steps=steps, san_check_val_step=0)
    fit_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    for hk in hooks:
        hk.remove()
    secs = [st["step_seconds"] for st in report.steps]
    losses = [st["train/total_loss"] for st in report.steps]
    log(f"{phase}: Trainer.fit(max_steps={steps}) at {data.batch_size} "
        f"{unit} a step took {fit_s:.1f}s (host clock"
        f"{', ckpt_last included' if ckp_path else ''}), steps " +
        " ".join(f"{x:.3f}" for x in secs) + " s" +
        (" (f32: " + " ".join(f"{x:.3f}" for x in f32_secs) + " s)"
         if f32_secs else "") + f", max allocated {peak:.2f} GiB" +
        (f" [{smi}]" if smi else ""))
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise SystemExit(f"{phase}: training losses {losses}")
    totals = dict.fromkeys(launch_counts(), 0)
    for st in report.steps:
        check_launches(st["launches"], f"{phase}: a training step", bf16,
                       need)
        for k, n in st["launches"].items():
            totals[k] += n
    if not every_param:
        return trainer, report, totals, secs, peak
    no_grad = [n for n, _ in trainable if n not in got or not bool(got[n])]
    still = [n for n, p in trainable if torch.equal(p, start[n])] \
        if steps > 1 else []
    if no_grad or still:
        raise SystemExit(f"{phase}: {len(no_grad)} trainable parameters got "
                         f"no gradient ({no_grad[:5]}), {len(still)} did "
                         f"not move ({still[:5]})")
    log(f"{phase}: {len(trainable)} trainable tensors all got non-zero "
        "gradients" + (" and moved" if steps > 1 else ""))
    return trainer, report, totals, secs, peak


def image_data(cfg, batch, steps):
    """`steps` batches of `batch` synthetic images at `cfg`'s resolution,
    the training settings for `fit_checked` (a log line every step, no
    checkpoint, no loader workers)."""
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
    tcfg = cfg.copy(print_iter=1, save_interval=100.0, num_workers=0)
    return tcfg, DataModule(SyntheticImageDataset(
        cfg.resolution, steps * batch, seed=0), None, batch, seed=0)


def image_validate(cfg, model, dev, gen, smi, phase):
    """`validate_against_plain` of the image `model` over IMG_EVAL_BATCHES
    batches of IMG_EVAL_BATCH synthetic images with masks. -> the
    kernels' launches."""
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
    B = IMG_EVAL_BATCH
    data = DataModule(SyntheticImageDataset(cfg.resolution, B, seed=0),
                      SyntheticImageDataset(cfg.resolution,
                                            IMG_EVAL_BATCHES * B, seed=1),
                      B, B, seed=0)
    return validate_against_plain(
        cfg.copy(use_ema=True, val_batch_size=B, num_workers=0), model, data,
        dev, gen, smi, phase,
        f"{IMG_EVAL_BATCHES} batches of {B} synthetic {cfg.resolution[0]}x"
        f"{cfg.resolution[1]} images")


def image_requests(model, inputs, phase, smi):
    """`encode`, `sample` (20 DPM-Solver++ steps, VQ decode) and
    `denoise` of the image `model`, eagerly and from CUDA graphs, each
    with the launch counts set to 0 just before it and read just after:
    encode exactly 1 slot attention, every UNet call exactly GN_PER_UNET
    GN and ATTN_PER_UNET attention through the model dtype's entries;
    the graphed request bit-identical to the eager one with the same
    launches. -> ({path: {kernel: launches}}, slots)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    img, x_t, t_model = inputs
    bf16 = model.compute_dtype == torch.bfloat16
    gn, attn = ("gn_silu_bf16", "attention_bf16") if bf16 else \
        ("gn_silu", "attention")
    calls = [0]
    hk = model.dm_decoder.unet.register_forward_pre_hook(
        lambda *_: calls.__setitem__(0, calls[0] + 1))
    B, S = img.shape[0], model.num_slots
    per_path, outs, failed = {}, {}, []
    slots = None
    for graphed in (False, True):
        fns = {s: build_serving_fn(model, s, graphed=graphed)
               for s in ("encode", "sample", "denoise")}
        for name, fn in (("encode", lambda: fns["encode"](img)),
                         ("sample", lambda: fns["sample"](0, slots)),
                         ("denoise", lambda: fns["denoise"](x_t, t_model,
                                                            slots))):
            if graphed:
                fn()  # the capture
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            calls[0] = 0
            t0 = time.time()
            out = fn()
            torch.cuda.synchronize()
            secs = time.time() - t0
            counts = launch_counts()
            if not graphed:
                n = calls[0]
                want = {"slot_attention": 1 if name == "encode" else 0,
                        gn: GN_PER_UNET * n, attn: ATTN_PER_UNET * n}
                if bf16:  # every GN call of the model takes the bulk route
                    want[f"{gn}.bulk"] = GN_PER_UNET * n
                want = dict(dict.fromkeys(counts, 0), **want)
                if name == "encode":
                    slots = out[0]
                    msum = (out[1].sum(1) - 1).abs().max().item()
                    if out[0].shape != (B, S, model.slot_size) or \
                            out[1].shape != (B, S, *model.resolution) or \
                            msum > 1e-4:
                        failed.append(f"encode {tuple(out[0].shape)} "
                                      f"{tuple(out[1].shape)} {msum:.1e}")
                outs[name] = out
                verdict = f"{n} UNet calls"
            else:
                want = per_path[name]
                verdict = "vs eager " + compare(f"graphed {name}", out,
                                                outs[name], failed)
            if counts != want or not all(torch.isfinite(o.float()).all()
                                         for o in outputs(out)):
                failed.append(f"{'graphed ' * graphed}{name} launches "
                              f"{nonzero(counts)} (want {nonzero(want)}) "
                              "or non-finite output")
            per_path[f"{'graphed_' * graphed}{name}"] = counts
            log(f"{phase}: {'graphed' if graphed else 'eager'} {name} of "
                f"{B} images in {secs:.3f} s (host clock) [{smi}]: "
                f"{verdict}; launches {nonzero(counts)}")
    hk.remove()
    if failed:
        raise SystemExit(f"{phase}: image serving failed: {failed}")
    return per_path, slots


def images(smi, dev, gen, phase="phase 11"):
    """Phase 11: the image family at full width. -> ({path: {kernel:
    launches}}, {kernel: totals} of slot attention at the image serving
    shape)."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.models import (build_model, init_random_,
                                                init_reference_)
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    t_phase = time.time()
    paths = {}
    cfg = configs.SALDMCLEVRTex128()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{phase}: built SADiffusion (SALDMCLEVRTex128, 128x128, "
        f"{IMG_SLOTS} slots x 3 iterations), {n_params / 1e6:.1f}M "
        "parameters, random weights (seed 0)")
    inputs = image_inputs(cfg, dev)
    img, x_t, t_model = inputs

    # slot attention at the image shape, timed; GN and attention at the
    # image serving shapes, checked
    shapes, handles = record_shapes(model)
    with torch.inference_mode():
        s0, _ = build_serving_fn(model, "encode", graphed=False)(img)
        build_serving_fn(model, "denoise", graphed=False)(x_t, t_model, s0)
    torch.cuda.synchronize()
    for hk in handles:
        hk.remove()
    sa_mod = model.slot_attention
    img_sa = check_kernels({"gn_silu": {}, "attention": {},
                            "slot_attention": shapes["slot_attention"]},
                           sa_mod, gen, dev, f"{phase} (image shape)")
    check_kernels(dict(shapes, slot_attention={}), sa_mod, gen, dev,
                  f"{phase} (image serving shapes)", timing=False)

    # serving, eager and graphed
    served, slots = image_requests(model, inputs, phase, smi)
    paths.update({f"image_{k}": v for k, v in served.items()})
    # one encode and one denoise against the same model on the CPU
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        d_gpu = build_serving_fn(model, "denoise", graphed=False)(
            x_t[:1], t_model[:1], slots[:1]).cpu()
        d_cpu = build_serving_fn(cpu, "denoise")(
            x_t[:1].cpu(), t_model[:1].cpu(), slots[:1].cpu())
        s_gpu, m_gpu = build_serving_fn(model, "encode", graphed=False)(
            img[:1])
        s_cpu, m_cpu = build_serving_fn(cpu, "encode")(img[:1].cpu())
    del cpu
    for name, a, b, tol in (("denoise", d_gpu, d_cpu, 1e-3),
                            ("encode slots", s_gpu.cpu(), s_cpu, 1e-2),
                            ("encode masks", m_gpu.cpu(), m_cpu, 1e-2)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"{phase}: {name} card vs CPU plain path: max rel err "
            f"{rel:.2e} (tol {tol:.0e})")
        if not rel <= tol:
            raise SystemExit(f"{phase}: {name}: the card disagrees with the "
                             "CPU")

    # training at the step's shapes
    model.dm_decoder.vae.requires_grad_(False)
    shapes, handles = record_shapes(model)
    H, W = cfg.resolution
    make_img = lambda bs: torch.rand(bs, H, W, 3, device=dev) * 2 - 1
    batch, _ = batch_that_fits(model, make_img, IMG_TRAIN_BATCHES, phase,
                               shapes)
    for hk in handles:
        hk.remove()
    check_kernels(shapes, sa_mod, gen, dev, f"{phase} (training shapes)",
                  timing=False)
    check_grads(model_grad_cases(shapes, sa_mod, gen, dev), gen, dev, phase)
    paths["image_training"] = fit_checked(
        model, *image_data(cfg, batch, IMG_STEPS), phase, IMG_STEPS,
        smi=smi)[2]
    paths["image_validate"] = image_validate(cfg, model, dev, gen, smi,
                                             phase)
    # the init `scripts/train_torch.py` starts from; its zero layers hold
    # the gradients of the layers behind them at 0 until they have moved,
    # so the every-parameter gate is the random init's run above
    init_reference_(model, torch.Generator().manual_seed(0))
    _, report, paths["image_training_reference_init"], _, _ = fit_checked(
        model, *image_data(cfg, batch, IMG_STEPS),
        f"{phase} (init_reference_)", IMG_STEPS, smi=smi, every_param=False)
    first = report.steps[0]["train/total_loss"]
    log(f"{phase} (init_reference_): first loss {first:.6f}, the noise's "
        f"mean square (1 +- {REF_INIT_LOSS_TOL})")
    if not abs(first - 1.0) <= REF_INIT_LOSS_TOL:
        raise SystemExit(f"{phase}: the first loss from init_reference_ is "
                         f"{first}, not the noise's mean square")
    del model, sa_mod, slots, s0
    gc.collect()
    torch.cuda.empty_cache()

    # bf16: one graphed sample and one training step
    cfg16 = cfg.copy(use_bf16=True)
    model = build_model(cfg16, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    with torch.inference_mode():
        slots16, _ = build_serving_fn(model, "encode", graphed=False)(img)
        graphed = build_serving_fn(model, "sample")
        eager = build_serving_fn(model, "sample", graphed=False)
        want = eager(0, slots16)
        graphed(0, slots16)  # the capture
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        got = graphed(0, slots16)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = launch_counts()
    fails = []
    verdict = compare("bf16 graphed sample", got, want, fails)
    log(f"{phase}: bf16 graphed sample of {IMG_SERVE} images in {secs:.3f} "
        f"s (host clock) [{smi}]: vs eager {verdict}; launches "
        f"{nonzero(counts)}")
    check_launches(counts, f"{phase}: bf16 graphed sample", True,
                   BF16_KERNELS[:2])
    if fails or counts["gn_silu_bf16"] % GN_PER_UNET or \
            counts["attention_bf16"] % ATTN_PER_UNET:
        raise SystemExit(f"{phase}: bf16 graphed sample failed: {fails}, "
                         f"{counts}")
    paths["image_bf16_graphed_sample"] = counts
    model.dm_decoder.vae.requires_grad_(False)
    paths["image_bf16_training"] = fit_checked(
        model, *image_data(cfg16, batch, 1), f"{phase} (bf16)", 1,
        bf16=True, smi=smi)[2]
    del model, graphed, eager
    gc.collect()
    torch.cuda.empty_cache()

    # the SA baseline
    sa_cfg = configs.SACLEVRTex128()
    model = build_model(sa_cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    serve_shapes, handles = record_shapes(model)
    with torch.inference_mode():
        out_k = model({"img": img})
    for hk in handles:
        hk.remove()
    with torch.inference_mode(), plain_versions(f32_slot_attention=False):
        out_p = model({"img": img})
    for k in ("slots", "recon_img"):
        rel = ((out_k[k].float() - out_p[k].float()).abs().max() /
               out_p[k].float().abs().max()).item()
        log(f"{phase}: SA {k} of {IMG_SERVE} images, kernels vs plain path: "
            f"max rel err {rel:.2e} (tol {IMG_PATH_TOL:.0e})")
        if not rel <= IMG_PATH_TOL:
            raise SystemExit(f"{phase}: SA {k}: the kernel path disagrees")
    del out_k, out_p
    shapes, handles = record_shapes(model)
    sa_batch, _ = batch_that_fits(model, make_img, IMG_TRAIN_BATCHES,
                                  f"{phase} (SA)", shapes)
    for hk in handles:
        hk.remove()
    # slot attention's no-mask return at SA's serving and training shapes
    for name, calls in serve_shapes.items():
        shapes[name].update(calls)
    check_kernels(shapes, model.slot_attention, gen, dev,
                  f"{phase} (SA shapes)", timing=False)
    paths["sa_training"] = fit_checked(
        model, *image_data(sa_cfg, sa_batch, IMG_STEPS), f"{phase} (SA)",
        IMG_STEPS, need=("slot_attention",), smi=smi)[2]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: done in {time.time() - t_phase:.1f} s [{smi}]")
    return paths, img_sa


def clip_data(cfg, batch, steps, load_mask=False, val_batches=0):
    """`steps` batches of `batch` synthetic clips at `cfg`'s resolution and
    clip length (a dVAE config's: single frames) and, with `val_batches`,
    a val split of that many batches of BASE_EVAL_BATCH clips; the
    training settings for `fit_checked` (a log line every step, no
    checkpoint but at the end, no loader workers)."""
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
    tcfg = cfg.copy(print_iter=1, save_interval=100.0, num_workers=0,
                    load_mask=load_mask, val_batch_size=BASE_EVAL_BATCH)
    train, val = synthetic_video_splits(tcfg, steps * batch,
                                        val_batches * BASE_EVAL_BATCH)
    return tcfg, DataModule(train, val, batch, BASE_EVAL_BATCH, seed=0)


def baseline_validate(model, tcfg, data, phase, want, per_batch, smi):
    """`Trainer.validate` of a baseline on `data`'s val split, with the
    launch counts set to 0 just before and read just after: exactly the
    keys `want`, finite; slot attention `per_batch` launches a batch; the
    live weights bit-identical after it. -> the launches."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.methods.build import build_method
    trainer = build_method(model, data, tcfg)
    live = {k: v.clone() for k, v in model.state_dict().items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    res = trainer.validate()
    torch.cuda.synchronize()
    secs = time.time() - t0
    counts = launch_counts()
    n = len(data.val_loader())
    log(f"{phase}: Trainer.validate over {n} batches of {BASE_EVAL_BATCH} "
        f"synthetic clips in {secs:.3f} s wall [{smi}]: " +
        ", ".join(f"{k} {v:.6f}" for k, v in sorted(res.items())) +
        f"; launches {nonzero(counts)}")
    want_counts = dict(dict.fromkeys(counts, 0),
                       slot_attention=per_batch * n)
    moved = [k for k, v in model.state_dict().items()
             if not torch.equal(v, live[k])]
    if set(res) != {f"val/{k}" for k in want} or \
            not all(map(math.isfinite, res.values())) or \
            counts != want_counts or moved:
        raise SystemExit(f"{phase}: validate gave {res}, launches {counts} "
                         f"(want {nonzero(want_counts)}), {len(moved)} "
                         "tensors changed")
    return counts


def ar_recon(model, slots, phase, what, smi):
    """`recon_img` of `slots` ([B, T, S, D] or [B, S, D]), timed; its
    greedy generation from a CUDA graph of one step (the default on the
    card) against the eager loop (the same ids and logits), and held
    against the plain path: the teacher-forced forward on the generated
    prefix gives logits within GEN_TOL of the logits' scale, and its
    argmax is the generated id wherever its two largest logits are
    further apart than twice the largest difference. -> {name: seconds
    or ms}."""
    import torch
    dec = model.trans_decoder
    flat = slots.reshape(-1, *slots.shape[-2:])
    steps = model.num_patches
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    out = {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.time()
        start.record()
        res = fn()
        end.record()
        torch.cuda.synchronize()
        out[f"{what}_{name}_s"] = time.time() - t0
        out[f"{what}_{name}_ms"] = start.elapsed_time(end)
        return res

    imgs = run("recon_img", lambda: model.recon_img(slots))
    with torch.no_grad():
        ids, logits = run("generate", lambda: dec.generate(flat, steps))
        e_ids, e_logits = run("generate_eager", lambda: dec.generate(
            flat, steps, graphed=False))
        forward = dec(flat, ids[:, :-1])
    same_eager = torch.equal(ids, e_ids)
    eager_diff = (logits - e_logits).abs().max().item()
    diff = (logits - forward).abs().max().item()
    rel = diff / forward.abs().max().item()
    top2 = forward.topk(2, dim=-1).values
    decided = top2[..., 0] - top2[..., 1] > 2 * diff
    same = ids == forward.argmax(-1)
    miss = (decided & ~same).sum().item()
    share = same.float().mean().item()
    ok = rel <= GEN_TOL and miss == 0 and same_eager and \
        eager_diff <= GEN_TOL * forward.abs().max().item() and \
        torch.isfinite(imgs).all().item() and \
        tuple(imgs.shape[-3:]) == (*model.resolution, 3)
    log(f"{phase}: {what} recon_img of {flat.shape[0]} frames x {steps} "
        f"tokens ({dec.vocab_size}-way, {dec.num_layers} blocks): "
        f"{out[f'{what}_recon_img_s']:.3f} s wall; generate from a CUDA "
        f"graph of one step {out[f'{what}_generate_s']:.3f} s wall "
        f"({out[f'{what}_generate_ms']:.1f} ms by CUDA events), eager "
        f"{out[f'{what}_generate_eager_s']:.3f} s "
        f"({out[f'{what}_generate_eager_ms']:.1f} ms) [{smi}]: ids "
        f"{'equal' if same_eager else 'DIFFER'}, logits max abs diff "
        f"{eager_diff:.2e}; vs the teacher-forced forward on its prefix: "
        f"logits max rel err {rel:.2e} (tol {GEN_TOL:.0e}), ids agree at "
        f"{share:.6f}, {miss} disagree away from ties (must be 0) "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{phase}: {what}'s AR generation disagrees with "
                         "its plain path")
    return out


def baseline_batch(model, make, batches, phase, unit):
    """`batch_that_fits` with the kernel calls of the probe recorded:
    -> (batch, {kernel: {shape key: calls}})."""
    shapes, handles = record_shapes(model)
    batch, _ = batch_that_fits(model, make, batches, phase, shapes,
                               unit=unit)
    for hk in handles:
        hk.remove()
    return batch, shapes


def baselines(smi, dev, gen, phase="phase 12"):
    """Phase 12: the token and reconstruction baselines at full width.
    -> ({path: {kernel: launches}}, {family: slot attention's totals at
    its training step's shapes}, {what: seconds})."""
    import gc
    import tempfile

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    from slotdiffusion_tpu_torch.training.checkpoint import graft_pretrained
    t_phase = time.time()
    paths, sa_results, secs = {}, {}, {}
    only_sa = {"gn_silu": {}, "attention": {}}

    def free(*_):
        gc.collect()
        torch.cuda.empty_cache()

    def clips(T, H, W):
        return lambda bs: torch.rand(bs, T, H, W, 3, device=dev) * 2 - 1

    # ---- SAVi: slot attention without masks, the broadcast decoder ----
    cfg = configs.SAViMoviE128()
    T, (H, W) = cfg.n_sample_frames, cfg.resolution
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    log(f"{phase}: built SAVi (SAViMoviE128, {H}x{W}, "
        f"{cfg.slot_dict['num_slots']} slots x "
        f"{cfg.slot_dict['num_iterations']} iterations, no masks), "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
        "parameters, random weights (seed 0)")
    try:
        build_serving_fn(model, "encode")
        raise SystemExit(f"{phase}: SAVi served encode")
    except ValueError as err:
        log(f"{phase}: SAVi's encode surface is refused: {err}")
    batch, shapes = baseline_batch(model, clips(T, H, W),
                                   BASE_TRAIN_BATCHES, f"{phase} (SAVi)",
                                   "clips")
    sa_results["savi"] = check_kernels(dict(shapes, **only_sa),
                                       model.slot_attention, gen, dev,
                                       f"{phase} (SAVi training shapes)")
    free()
    paths["savi_training"] = fit_checked(
        model, *clip_data(cfg, batch, BASE_STEPS), f"{phase} (SAVi)",
        BASE_STEPS, need=("slot_attention",), unit="clips", smi=smi)[2]
    paths["savi_validate"] = baseline_validate(
        model, *clip_data(cfg, BASE_EVAL_BATCH, 1, True, BASE_EVAL_BATCHES),
        f"{phase} (SAVi)",
        ("img_recon_loss", "ari", "fari", "miou", "fmiou", "mbo"), T, smi)
    del model
    free()

    with tempfile.TemporaryDirectory() as tmp:
        # ---- the dVAE: stage 1, no kernel (flax layers in the JAX one) -
        dcfg = configs.DVAEMoviE128()
        dvae = build_model(dcfg, device=dev)
        init_random_(dvae, torch.Generator().manual_seed(0))
        log(f"{phase}: built the dVAE (DVAEMoviE128, {H}x{W} frames, "
            f"{dcfg.vocab_size} tokens), "
            f"{sum(p.numel() for p in dvae.parameters()) / 1e6:.2f}M "
            "parameters, random weights (seed 0)")
        frames, _ = baseline_batch(dvae, clips(1, H, W), DVAE_BATCHES,
                                   f"{phase} (dVAE)", "frames")
        seen = []
        compute = dvae.compute_losses

        def noting(batch, gen_, train=True, sched=None):
            seen.append(sched["gumbel_tau"])
            return compute(batch, gen_, train=train, sched=sched)

        dvae.compute_losses = noting
        tcfg, data = clip_data(dcfg, frames, BASE_STEPS)
        _, _, paths["dvae_training"], _, _ = fit_checked(
            dvae, tcfg, data, f"{phase} (dVAE)", BASE_STEPS, need=(),
            ckp_path=tmp, unit="frames", smi=smi)
        dvae.compute_losses = compute
        log(f"{phase} (dVAE): gumbel tau at the steps "
            + " ".join(f"{x:.6f}" for x in seen) + f" (from "
            f"{dcfg.init_tau} to {dcfg.final_tau} over "
            f"{dcfg.tau_decay_pct} of the run); launches "
            f"{nonzero(paths['dvae_training'])} (must be none: its norms "
            "are F.group_norm)")
        if any(paths["dvae_training"].values()) or len(seen) != BASE_STEPS \
                or not seen[0] > seen[1] > seen[2]:
            raise SystemExit(f"{phase}: the dVAE launched a kernel or its "
                             f"temperature did not move: {seen}")
        ckpt = os.path.join(tmp, "ckpt_last.pt")
        dvae_state = {k: v.clone() for k, v in dvae.state_dict().items()}
        del dvae, data
        free()

        # ---- STEVE on that dVAE --------------------------------------
        cfg = configs.STEVEMoviE128()
        cfg = cfg.copy(dvae_dict=dict(cfg.dvae_dict, dvae_ckp_path=ckpt))
        model = build_model(cfg, device=dev)
        init_random_(model, torch.Generator().manual_seed(0))
        if not graft_pretrained(model, cfg) or any(
                not torch.equal(v, dvae_state[k])
                for k, v in model.dvae.state_dict().items()):
            raise SystemExit(f"{phase}: the grafted dVAE differs from the "
                             "stage-1 model")
        del dvae_state
        log(f"{phase}: built STEVE (STEVEMoviE128, "
            f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
            "parameters, random weights, seed 0) and grafted the dVAE's "
            f"ckpt_last.pt ({os.path.getsize(ckpt) / 2.0 ** 20:.1f} MiB) "
            "through graft_pretrained: bit-identical")
        video = clips(T, H, W)(RECON_CLIPS)
        outs, counts = [], []
        for graphed in (False, True):
            fn = build_serving_fn(model, "encode", graphed=graphed)
            if graphed:
                fn(video)  # the capture
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.time()
            outs.append(fn(video))
            torch.cuda.synchronize()
            secs[f"steve_encode{'_graphed' * graphed}"] = time.time() - t0
            counts.append(launch_counts())
        fails = []
        verdict = compare(f"{phase}: STEVE graphed encode", outs[1],
                          outs[0], fails)
        # one slot attention a frame, over the batch
        want = dict(dict.fromkeys(counts[0], 0), slot_attention=T)
        msum = (outs[0][1].sum(2) - 1).abs().max().item()
        log(f"{phase}: STEVE encode of {RECON_CLIPS} clips x {T} frames: "
            f"eager {secs['steve_encode']:.3f} s, graphed "
            f"{secs['steve_encode_graphed']:.3f} s (host clock) [{smi}]; "
            f"graphed vs eager {verdict}; masks "
            f"{tuple(outs[0][1].shape)} at the visual resolution, summing "
            f"to 1 over the slots within {msum:.1e}; "
            f"launches {nonzero(counts[0])}")
        if fails or counts[0] != want or counts[1] != want or \
                msum > 1e-4 or tuple(outs[0][0].shape) != (
                    RECON_CLIPS, T, model.num_slots, model.slot_size):
            raise SystemExit(f"{phase}: STEVE encode failed: {fails}, "
                             f"{counts}")
        paths["steve_encode"], paths["steve_graphed_encode"] = counts
        slots = outs[0][0]
        del outs, fn
        model.dvae.requires_grad_(False)
        batch, shapes = baseline_batch(model, clips(T, H, W),
                                       BASE_TRAIN_BATCHES,
                                       f"{phase} (STEVE)", "clips")
        sa_results["steve"] = check_kernels(
            dict(shapes, **only_sa), model.savi.slot_attention, gen, dev,
            f"{phase} (STEVE training shapes)")
        free()
        paths["steve_training"] = fit_checked(
            model, *clip_data(cfg, batch, BASE_STEPS), f"{phase} (STEVE)",
            BASE_STEPS, need=("slot_attention",), unit="clips", smi=smi)[2]
        # its masks are at the visual resolution and the JAX metrics take
        # no upsampling: validate reads the losses
        paths["steve_validate"] = baseline_validate(
            model, *clip_data(cfg, BASE_EVAL_BATCH, 1, False,
                              BASE_EVAL_BATCHES),
            f"{phase} (STEVE)", ("token_recon_loss",), T, smi)
        free()
        secs.update(ar_recon(model, slots, phase, "steve", smi))
        del model, slots
        free()

    # ---- SLATE: images, slot attention with masks over 3 iterations ----
    cfg = configs.SLATECLEVRTex128()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    log(f"{phase}: built SLATE (SLATECLEVRTex128, "
        f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f}M "
        "parameters, random weights, seed 0)")
    model.dvae.requires_grad_(False)
    make_img = lambda bs: torch.rand(bs, H, W, 3, device=dev) * 2 - 1
    batch, shapes = baseline_batch(model, make_img, IMG_TRAIN_BATCHES,
                                   f"{phase} (SLATE)", "images")
    sa_results["slate"] = check_kernels(
        dict(shapes, **only_sa), model.slot_attention, gen, dev,
        f"{phase} (SLATE training shapes)")
    free()
    paths["slate_training"] = fit_checked(
        model, *image_data(cfg, batch, BASE_STEPS), f"{phase} (SLATE)",
        BASE_STEPS, need=("slot_attention",), smi=smi)[2]
    with torch.no_grad():
        slots = model({"img": make_img(RECON_IMAGES)}, testing=True)[
            "slots"]
    secs.update(ar_recon(model, slots, phase, "slate", smi))
    del model, slots
    free()
    log(f"{phase}: done in {time.time() - t_phase:.1f} s [{smi}]")
    return paths, sa_results, secs


def gn_long(gen, dev, phase, train_batch):
    """The GN kernel's runs over 32,768 values at GN_LONG_SHAPES (the f32
    entry's two-pass path, the bf16 entry's bulk route), and the bf16
    entry's two-pass and ragged routes at GN_BF16_ROUTE_CASES, SiLU on,
    against the plain version: relative error within GN_LONG_TOL, two
    calls bit-identical, each bf16 call on the route `bf16_route` names;
    the first shape in f32 timed beside the plain version,
    `F.silu(F.group_norm)` and the bounds (the function's: x read and y
    written once; the design's: x read twice). -> that shape's numbers.
    Raises SystemExit if any disagrees."""
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import fused_norm
    failed, res = [], None
    cases = [(B or train_batch, C, H, W, 32, dname)
             for B, C, H, W in GN_LONG_SHAPES for dname in ("f32", "bf16")]
    cases += [(B, C, H, W, G, "bf16")
              for B, C, H, W, G, _ in GN_BF16_ROUTE_CASES]
    want = {tuple(case[:5]): case[5] for case in GN_BF16_ROUTE_CASES}
    for B, C, H, W, G, dname in cases:
        dt = torch.float32 if dname == "f32" else torch.bfloat16
        entry = fused_norm.ENTRY[dt]
        L = C // G * H * W
        chunk, count = fused_norm.long_plan(L)
        x = (torch.randn(B, C, H, W, generator=gen, device=dev) * 2 +
             0.5).to(dt)
        w = 1 + 0.1 * torch.randn(C, generator=gen, device=dev)
        b = 0.1 * torch.randn(C, generator=gen, device=dev)
        kern = lambda: fused_norm.fused_group_norm(x, w, b, G, 1e-5, "silu")
        plain = lambda: fused_norm.group_norm_reference(x, w, b, G, 1e-5,
                                                        "silu")
        before = dict(fused_norm.route_launches)
        y, y2, ref = kern(), kern(), plain()
        taken = [r for r in fused_norm.ROUTES
                 if fused_norm.route_launches.get(f"{entry}.{r}", 0) >
                 before.get(f"{entry}.{r}", 0)]
        route = "two_pass" if dname == "f32" else want.get((B, C, H, W, G),
                                                          "bulk")
        same = torch.equal(y, y2)
        abs_err = (y.float() - ref.float()).abs().max().item()
        rel = abs_err / ref.float().abs().max().item()
        ok = same and rel <= GN_LONG_TOL[dname] and (
            dname == "f32" or taken == [route] == [fused_norm.bf16_route(
                L, x.data_ptr() % 16 == 0)])
        how = {"two_pass": f"in {count} chunks of {chunk}",
               "ragged": "in registers",
               "bulk": "through shared memory"}[route]
        log(f"{phase}: gn_silu ({B}, {C}, {H}, {W}) G={G} {dname}: {L} "
            f"values a group, route {route} {how}"
            f"{f' (launched: {taken})' if dname == 'bf16' else ''}; max rel "
            f"err {rel:.3e} (tol {GN_LONG_TOL[dname]:.1e}), two calls "
            f"{'bit-identical' if same else 'DIFFER'} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"({B}, {C}, {H}, {W}) G={G} {dname}")
        if res is None and dname == "f32":
            n = x.numel()
            k_t, p_t = timed(kern), timed(plain)
            l_t = timed(lambda: F.silu(F.group_norm(x, 32, w, b, 1e-5)))
            terms = bound_terms(2 * n * 4 + 2 * C * 4, f32_ops=10 * n)
            design = 1e3 * (3 * n * 4 + 2 * C * 4) / HBM_BYTES_PER_S
            res = dict(shape=[B, C, H, W], group=L, chunk=chunk,
                       chunks=count, ms=k_t[0], event_ms=k_t[1],
                       plain_ms=p_t[0], library_ms=l_t[0],
                       bound_ms=max(terms),
                       bound_by="bytes" if terms[0] >= terms[1]
                       else "operations",
                       design_bound_ms=design, max_abs_err=abs_err)
            log(f"{phase}: gn_silu two-pass ({B}, {C}, {H}, {W}) f32 "
                f"device (event) ms: kernel {k_t[0]:.4f} ({k_t[1]:.4f}),"
                f" plain {p_t[0]:.4f}, library {l_t[0]:.4f}, bound "
                f"{max(terms):.4f} (x and y once), design bound "
                f"{design:.4f} (x read twice)")
    if failed:
        raise SystemExit(f"{phase}: the GN long runs or bf16 routes "
                         f"disagree: {failed}")
    return res


def sdpa_bf16(shapes, gen, dev, phase, tokens=784):
    """At the serving path's self-attention of `tokens` keys: the
    attention kernel's bf16 entry against its plain version (at
    BF16_TOL of the largest output) and against
    `scaled_dot_product_attention` on the same bf16 q, k, v (the library
    yardstick), timed, and the bound. -> {shape, ms, library_ms,
    plain_ms, bound_ms, max_abs_err (vs the plain version),
    library_max_abs_diff}. Raises SystemExit past the tolerance."""
    import torch
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch.ops import attention_kernel
    Bq, nq, nk, heads = next(k for k in shapes["attention"]
                             if k[1] == k[2] == tokens)
    hd = heads * attention_kernel.HEAD_DIM
    q, k, v = (torch.randn(Bq, tokens, hd, generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    split = lambda t: t.view(Bq, tokens, heads, -1).transpose(1, 2)
    kern = lambda: attention_kernel.fused_mha(q, k, v, heads)
    plain = lambda: attention_kernel.mha_reference(q, k, v, heads)
    lib = lambda: F.scaled_dot_product_attention(split(q), split(k),
                                                 split(v))
    out, ref = kern(), plain()
    err = max_err(out, ref)
    tol = BF16_TOL["attention_bf16"] * ref.float().abs().max().item()
    diff = (out.float() - lib().transpose(1, 2).reshape(Bq, tokens, hd)
            .float()).abs().max().item()
    k_t, l_t, p_t = timed(kern), timed(lib), timed(plain)
    terms = bound_terms(2 * (4 * q.numel()),
                        bf16_ops=4.0 * Bq * tokens * tokens * hd)
    bound = max(terms)
    log(f"{phase}: attention_bf16 B={Bq} Nq=Nk={tokens} H={heads}: "
        f"max_abs_err vs its plain version {err:.3e} (tol {tol:.1e}) "
        f"{'ok' if err <= tol else 'FAIL'} | device ms: kernel "
        f"{k_t[0]:.4f}, scaled_dot_product_attention {l_t[0]:.4f} "
        f"(kernel/library {k_t[0] / l_t[0]:.3f}), plain {p_t[0]:.4f}, "
        f"bound {bound:.4f} ({'bytes' if terms[0] >= terms[1] else 'operations'}"
        f"; kernel/bound {k_t[0] / bound:.1f}); max_abs_diff from SDPA "
        f"{diff:.3e}")
    if not err <= tol:
        raise SystemExit(f"{phase}: attention_bf16 at {tokens} tokens is "
                         f"{err:.3e} from its plain version (tol {tol:.1e})")
    return dict(shape=[Bq, tokens, tokens, heads], ms=k_t[0],
                library_ms=l_t[0], plain_ms=p_t[0], bound_ms=bound,
                max_abs_err=err, library_max_abs_diff=diff)


def coco_data(cfg, batch, steps, val_batches=0):
    """`steps` batches of `batch` synthetic COCO images at `cfg`'s
    resolution (and `val_batches` val batches of COCO_EVAL_BATCH) through
    the COCO collater, with the training settings for `fit_checked`."""
    from slotdiffusion_tpu_torch.data.coco import coco_collate_fn
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticCOCODataset
    tcfg = cfg.copy(print_iter=1, save_interval=100.0, num_workers=0,
                    val_batch_size=COCO_EVAL_BATCH)
    val = SyntheticCOCODataset(cfg.resolution, val_batches * COCO_EVAL_BATCH,
                               seed=1) if val_batches else None
    return tcfg, DataModule(
        SyntheticCOCODataset(cfg.resolution, steps * batch, seed=0), val,
        batch, COCO_EVAL_BATCH, seed=0, collate_fn=coco_collate_fn)


def coco_voc(smi, dev, gen, phase="phase 13"):
    """Phase 13: SADiffusion with the frozen DINO ViT at 224x224, full
    width. -> ({path: launches}, {kernel: totals at the COCO serving
    shapes}, the GN two-pass numbers, the bf16 SDPA yardstick)."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.ops import fused_norm
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    t_phase = time.time()
    paths = {}
    cfg = configs.SALDMDINOCOCO224()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    dino = model.encoder.encoder.dino
    n_params = sum(p.numel() for p in model.parameters())
    log(f"{phase}: built SADiffusion (SALDMDINOCOCO224, 224x224, 7 slots x "
        f"256 x 3 iterations, DINO ViT-S/8 frozen: "
        f"{sum(p.numel() for p in dino.parameters()) / 1e6:.1f}M), "
        f"{n_params / 1e6:.1f}M parameters, random weights (seed 0)")
    inputs = image_inputs(cfg, dev)
    img, x_t, t_model = inputs

    # the kernels at the serving shapes: checked, timed, bit-identical
    shapes, handles = record_shapes(model)
    with torch.inference_mode():
        s0, _ = build_serving_fn(model, "encode", graphed=False)(img)
        build_serving_fn(model, "denoise", graphed=False)(x_t, t_model, s0)
    torch.cuda.synchronize()
    for hk in handles:
        hk.remove()
    long_calls = sum(n for (shape, _, _, G), n in shapes["gn_silu"].items()
                     if shape[1] // G * shape[2] * shape[3] >
                     fused_norm.MAX_GROUP)
    log(f"{phase}: a UNet call at 56x56 latents: "
        f"{sum(shapes['gn_silu'].values())} GN calls, {long_calls} of them "
        f"over {fused_norm.MAX_GROUP} values a group (the two-pass path); "
        f"attention shapes {sorted(shapes['attention'])}; slot attention "
        f"{sorted(shapes['slot_attention'])}")
    if not long_calls:
        raise SystemExit(f"{phase}: no GN call reached the two-pass path")
    sa_mod = model.slot_attention
    coco_k = check_kernels(shapes, sa_mod, gen, dev,
                           f"{phase} (COCO serving shapes)")
    sdpa = sdpa_bf16(shapes, gen, dev, phase)

    # serving, eager and graphed (masks of 224x224 summing to 1)
    served, slots = image_requests(model, inputs, phase, smi)
    paths.update({f"coco_{k}": v for k, v in served.items()})
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    with torch.inference_mode():
        d_gpu = build_serving_fn(model, "denoise", graphed=False)(
            x_t[:1], t_model[:1], slots[:1]).cpu()
        d_cpu = build_serving_fn(cpu, "denoise")(
            x_t[:1].cpu(), t_model[:1].cpu(), slots[:1].cpu())
        s_gpu, m_gpu = build_serving_fn(model, "encode", graphed=False)(
            img[:1])
        s_cpu, m_cpu = build_serving_fn(cpu, "encode")(img[:1].cpu())
    del cpu
    for name, a, b, tol in (("denoise", d_gpu, d_cpu, 1e-3),
                            ("encode slots", s_gpu.cpu(), s_cpu, 1e-2),
                            ("encode masks", m_gpu.cpu(), m_cpu, 1e-2)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"{phase}: {name} card vs CPU plain path: max rel err "
            f"{rel:.2e} (tol {tol:.0e})")
        if not rel <= tol:
            raise SystemExit(f"{phase}: {name}: the card disagrees with the "
                             "CPU")

    # training: DINO and the VQ-VAE frozen
    for m in model.frozen_modules:
        m.requires_grad_(False)
    dino_start = {n: p.detach().clone() for n, p in dino.named_parameters()}
    shapes, handles = record_shapes(model)
    H, W = cfg.resolution
    make_img = lambda bs: torch.rand(bs, H, W, 3, device=dev) * 2 - 1
    batch, _ = batch_that_fits(model, make_img, COCO_TRAIN_BATCHES, phase,
                               shapes)
    for hk in handles:
        hk.remove()
    check_kernels(shapes, sa_mod, gen, dev, f"{phase} (training shapes)",
                  timing=False)
    check_grads(model_grad_cases(shapes, sa_mod, gen, dev), gen, dev, phase)
    gn_res = gn_long(gen, dev, phase, batch)
    trainer, _, paths["coco_training"], secs, peak = fit_checked(
        model, *coco_data(cfg, batch, COCO_STEPS), phase, COCO_STEPS,
        smi=smi)
    del trainer
    stale = [n for n, p in dino.named_parameters()
             if p.grad is not None or not torch.equal(p, dino_start[n])]
    log(f"{phase}: {COCO_STEPS} steps at {batch} images ("
        + ("the config's 64" if batch == 64 else f"cut from 64 to {batch}")
        + f"): step seconds {' '.join(f'{x:.3f}' for x in secs)}, peak "
        f"{peak:.2f} GiB [{smi}]; DINO's {len(dino_start)} tensors "
        + ("bit-identical, no gradient" if not stale
           else f"CHANGED {stale[:3]}"))
    if stale:
        raise SystemExit(f"{phase}: the frozen DINO moved: {stale[:5]}")
    vcfg, vdata = coco_data(cfg, COCO_EVAL_BATCH, 1, COCO_EVAL_BATCHES)
    paths["coco_validate"] = validate_against_plain(
        vcfg.copy(use_ema=True), model, vdata, dev, gen, smi, phase,
        f"{COCO_EVAL_BATCHES} batches of {COCO_EVAL_BATCH} synthetic COCO "
        f"{H}x{W} images (dual inst/sem protocol)", dual=True)
    del model, sa_mod, slots, s0, dino, dino_start
    gc.collect()
    torch.cuda.empty_cache()

    # VOC: 6 slots x 192
    voc = configs.SALDMDINOVOC224()
    model = build_model(voc, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    for m in model.frozen_modules:
        m.requires_grad_(False)
    shapes, handles = record_shapes(model)
    batch_that_fits(model, make_img, (batch,), f"{phase} (VOC)", shapes)
    for hk in handles:
        hk.remove()
    check_kernels(shapes, model.slot_attention, gen, dev,
                  f"{phase} (VOC training shapes)", timing=False)
    paths["voc_training"] = fit_checked(
        model, *coco_data(voc, batch, VOC_STEPS), f"{phase} (VOC)",
        VOC_STEPS, smi=smi)[2]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: done in {time.time() - t_phase:.1f} s [{smi}]")
    return paths, coco_k, gn_res, sdpa



class SlotClips:
    """In-memory clips of slots [n, T, N, C], with labels [n] if given."""

    def __init__(self, slots, labels=None):
        self.slots, self.labels = slots, labels

    def __len__(self):
        return len(self.slots)

    def __getitem__(self, i):
        out = {"slots": self.slots[i], "data_idx": i}
        if self.labels is not None:
            out["label"] = self.labels[i]
        return out


def vp_encode(cfg, dev, gen, phase):
    """Phase 14's encode: SAViDiffusion (`cfg`, random weights) over
    VP_VIDEOS in-memory videos of VP_FRAMES frames through
    `chunked_video_apply` in chunks of its clip, slot attention held
    against its plain version at the shapes it took, each chunk replayed
    through the plain versions from the kernel path's carried slots.
    -> (the videos, their slots, the launches)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.methods.inference import chunked_video_apply
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    enc = build_model(cfg, device=dev)
    init_random_(enc, torch.Generator().manual_seed(0))
    H, W = cfg.resolution
    clip, S = cfg.n_sample_frames, cfg.slot_dict["num_slots"]
    video = torch.rand(VP_VIDEOS, VP_FRAMES, H, W, 3, generator=gen,
                       device=dev) * 2 - 1
    apply = lambda x, prev: enc({"img": x}, prev_slots=prev)
    keys = ("slots", "masks")
    shapes, handles = record_shapes(enc)
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        out = chunked_video_apply(apply, video, clip, keys=keys)
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = launch_counts()
    for hk in handles:
        hk.remove()
    check_launches(counts, f"{phase}: encode", False,
                   need=("slot_attention",))
    slots, masks = out["slots"], out["masks"]
    sums = (masks.sum(2) - 1).abs().max().item()
    if slots.shape != (VP_VIDEOS, VP_FRAMES, S, cfg.slot_dict["slot_size"])\
            or masks.shape != (VP_VIDEOS, VP_FRAMES, S, H, W) or \
            not bool(torch.isfinite(slots).all()) or not sums < 1e-4:
        raise SystemExit(f"{phase}: encode gave slots {tuple(slots.shape)}, "
                         f"masks {tuple(masks.shape)} (sums off by {sums})")
    log(f"{phase}: encode of {VP_VIDEOS} videos x {VP_FRAMES} frames of "
        f"{H}x{W} in {clip}-frame chunks: {secs:.2f} s wall, launches "
        f"{nonzero(counts)}, slots {tuple(slots.shape)}, masks summing to 1 "
        f"within {sums:.1e}")
    check_kernels(shapes, enc.savi.slot_attention, gen, dev,
                  f"{phase} (encode shapes)", timing=False)
    # each chunk through the plain versions (slot attention's twin with
    # bf16 k/v) from the kernel path's slots, and the whole plain path
    worst = dict.fromkeys(keys, 0.0)
    with torch.inference_mode(), plain_versions(False):
        for s0 in range(0, VP_FRAMES, clip):
            o = apply(video[:, s0:s0 + clip],
                      slots[:, s0 - 1] if s0 else None)
            for k in keys:
                a = out[k][:, s0:s0 + clip]
                b = o[k][:, :a.shape[1]]
                worst[k] = max(worst[k], ((a - b).abs().max() /
                                          b.abs().max()).item())
        plain = chunked_video_apply(apply, video, clip, keys=("slots",))
    drift = ((slots - plain["slots"]).abs().max() /
             plain["slots"].abs().max()).item()
    ok = all(v <= VP_ENC_TOL for v in worst.values())
    log(f"{phase}: encode, each of {VP_FRAMES // clip} chunks replayed "
        f"through the plain versions from the carried slots: largest "
        f"difference slots {worst['slots']:.2e}, masks {worst['masks']:.2e} "
        f"of their scale (tol {VP_ENC_TOL:.0e}) {'ok' if ok else 'FAIL'}; "
        f"the whole plain path's slots after {VP_FRAMES} frames differ by "
        f"{drift:.2e} of their scale (carried, not gated)")
    if not ok:
        raise SystemExit(f"{phase}: the encode disagrees with its plain "
                         "versions")
    return video, slots, counts


def dpm_twin(dm, z0, cond, x_T, calls, frames):
    """The plain-version twin of `frames` (decoded by the kernels from the
    final latents `z0` of DPM-Solver++ on `cond` from `x_T`): the same
    sampler from the same x_T through the plain versions, its VQ codes
    against the kernels' (CODE_AGREE, SAME_CODE_TOL; outside them, the
    kernel path from an x_T one rounding away tells a chaotic chain, as
    phase 10's control), and the recorded UNet `calls` replayed through
    the plain versions (PER_CALL_TOL). -> (ok, verdict)."""
    import torch
    with torch.inference_mode(), plain_versions(True):
        t1 = time.time()
        twin = dm.generate_imgs(None, cond=cond, use_dpm=True,
                                same_noise=True, x_T=x_T)
        plain = dm.decode_latent(twin).float()
        torch.cuda.synchronize()
        twin_s = time.time() - t1
        per_call = max(((o - dm.unet(x, t, c)).abs().max() / o.abs().max()
                        ).item() for x, t, c, o in calls)
    gate, scale = CODE_AGREE["dpm"], plain.abs().max().item()
    with torch.inference_mode():
        score, whole = final_distance(dm, True, z0, twin)
    same_err = ((frames[whole] - plain[whole]).abs().max().item() / scale
                if whole.any() else 0.0)
    inside = score >= gate and same_err <= SAME_CODE_TOL
    verdict = (f"the plain twin {twin_s:.2f} s: codes agree at {score:.6f} "
               f"(gate >= {gate}), {int(whole.sum())} of {len(cond)} frames "
               f"with every code equal, their largest difference "
               f"{same_err:.2e} (tol {SAME_CODE_TOL:.0e})")
    chaotic = False
    if not inside:
        with torch.inference_mode():
            again = dm.generate_imgs(None, cond=cond, use_dpm=True,
                                     same_noise=True,
                                     x_T=x_T * (1.0 + CONTROL_EPS))
            control, _ = final_distance(dm, True, again, z0)
        chaotic = control < gate
        verdict += (f"; outside: the kernel path from x_T x (1 + "
                    f"{CONTROL_EPS:.1e}) agrees with itself at {control:.6g}"
                    ": " + ("a chaotic chain, not a gate" if chaotic
                            else "a stable chain"))
    ok = (inside or chaotic) and per_call <= PER_CALL_TOL["f32"]
    return ok, (f"{verdict}; {len(calls)} calls replayed through the plain "
                f"versions: largest difference {per_call:.2e} of the output "
                f"scale (tol {PER_CALL_TOL['f32']:.0e})")


def unet_launches(counts, n_calls, sa, what):
    """`counts` are exactly GN_PER_UNET GN and ATTN_PER_UNET attention
    launches a UNet call of `n_calls` and `sa` slot attention launches, and
    nothing else. Raises SystemExit otherwise."""
    want = dict.fromkeys(counts, 0)
    want.update(gn_silu=GN_PER_UNET * n_calls,
                attention=ATTN_PER_UNET * n_calls, slot_attention=sa)
    if counts != want or not any(want.values()):
        raise SystemExit(f"{what}: {n_calls} UNet calls launched "
                         f"{nonzero(counts)}, not {nonzero(want)}")


def vp_decode(model, past, gt, roll, dev, gen, phase, smi):
    """test_vp's path: `model.rollout(past, roll, decode=True,
    with_gt=False)` from one shared x_T (DPM-Solver++ with the GN and
    attention kernels, then the VQ decode), its launches, the kernels at
    its shapes, the plain-path twin from the same x_T, each UNet call
    replayed through the plain versions (`dpm_twin`), MSE/PSNR/SSIM
    against `gt`. -> the launches."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.models.diffusion import noise_like
    from slotdiffusion_tpu_torch.ops import metrics as M
    dm = model.dm_decoder
    n = past.shape[0] * roll
    x_T = noise_like(gen, (n, *dm.resolution, dm.channels), True, dev)
    z = []
    shapes, handles = record_shapes(model)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode(), unet_calls(dm, [0]) as calls, \
            sampled_latents(dm, z):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        start.record()
        out = model.rollout(past, roll, decode=True, with_gt=False, x_T=x_T)
        end.record()
        torch.cuda.synchronize()
        secs = time.time() - t0
        counts = launch_counts()
    for hk in handles:
        hk.remove()
    unet_launches(counts, len(calls), 0, f"{phase}: decode")
    check_kernels(shapes, None, gen, dev, f"{phase} (decode shapes)",
                  timing=False)
    frames = out["recon_combined"].flatten(0, 1).float()
    ok, verdict = dpm_twin(dm, z[0], out["slots"].flatten(0, 1), x_T, calls,
                           frames)
    x = (frames * 0.5 + 0.5).clamp(0, 1)
    y = (gt.flatten(0, 1).float() * 0.5 + 0.5).clamp(0, 1)
    scores = {"mse": M.mse_metric(x, y), "psnr": M.psnr_metric(x, y),
              "ssim": M.ssim_metric(x, y)}
    ok = ok and bool(torch.isfinite(frames).all())
    log(f"{phase}: decode of {past.shape[0]} rollouts x {roll} frames "
        f"(test_vp's path): {len(calls)} UNet calls, {secs:.2f} s wall, "
        f"{start.elapsed_time(end):.1f} ms CUDA events, launches "
        f"{nonzero(counts)}; kernels vs {verdict}; against the clips' frames "
        + " ".join(f"{k} {v:.4f}" for k, v in scores.items())
        + f" (random weights) {'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise SystemExit(f"{phase}: the decode disagrees with its plain "
                         "versions")
    return counts


def vp_vqa(smi, dev, gen, phase="phase 14"):
    """Phase 14: the video-prediction and VQA stage at full width, random
    weights: SAViDiffusion's encode of whole videos (slot attention),
    LDMSlotFormer's training on clips of those slots and its rollout of
    the videos (no kernel: a plain transformer), test_vp's decode (GN
    and attention), the readout's training and validation (no kernel).
    -> {path: launches}."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic_slots import \
        SyntheticSlotsDataset
    from slotdiffusion_tpu_torch.methods.inference import interleaved_rollout
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.training.trainer import JSONLLogger
    t_phase = time.time()
    paths = {}
    video, slots, paths["vp_encode"] = vp_encode(
        configs.SAViLDMPhysion128(), dev, gen, phase)
    gc.collect()
    torch.cuda.empty_cache()

    # LDMSlotFormer: clips of 25 slot frames 3 apart cut from the videos
    cfg = configs.LDMSlotFormerPhysion128()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    hist, roll = cfg.rollout_dict["history_len"], cfg.loss_dict["rollout_len"]
    off, span = cfg.frame_offset, (cfg.n_sample_frames - 1) * cfg.frame_offset
    starts = [(v, s) for s in range(VP_FRAMES - span)
              for v in range(VP_VIDEOS)]
    clips = torch.stack([slots[v, s:s + span + 1:off] for v, s in starts])
    batch = cfg.train_batch_size
    if len(clips) < batch:
        raise SystemExit(f"{phase}: {len(clips)} clips make no batch of "
                         f"{batch}")
    data = DataModule(SlotClips(clips.cpu()), None, batch, seed=0)
    for m in model.frozen_modules:
        m.requires_grad_(False)
    ldm_start = {n: p.detach().clone()
                 for n, p in model.dm_decoder.named_parameters()}
    # the first step's batch: its loss on the card, and on VP_CPU_CLIPS of
    # it on the card and on the CPU (the port's SlotFormer with the same
    # rollouter: the loss reads nothing else)
    first = next(iter(data.train_loader(0)))["slots"]
    cpu = build_model(cfg.copy(model="SlotFormer", dec_dict={}),
                      device="cpu")
    cpu.rollouter.load_state_dict({k: v.cpu() for k, v in
                                   model.rollouter.state_dict().items()})
    loss = lambda m, x: m.compute_losses({"slots": x})[1][
        "slot_recon_loss"].item()
    with torch.no_grad():
        full = loss(model, first.to(dev))
        part = loss(model, first[:VP_CPU_CLIPS].to(dev))
        ref = loss(cpu, first[:VP_CPU_CLIPS])
    tcfg = cfg.copy(print_iter=1, save_interval=100.0, num_workers=0)
    trainer, report, paths["vp_training"], secs, peak = fit_checked(
        model, tcfg, data, phase, VP_STEPS, need=(), unit="clips of slots",
        smi=smi)
    del trainer
    step1 = report.steps[0]["train/slot_recon_loss"]
    stale = [n for n, p in model.dm_decoder.named_parameters()
             if p.grad is not None or not torch.equal(p, ldm_start[n])]
    rel_cpu, rel_step = abs(part - ref) / abs(ref), abs(step1 - full) / abs(
        full)
    n_roll = sum(p.numel() for p in model.rollouter.parameters())
    log(f"{phase}: LDMSlotFormer {VP_STEPS} steps at {batch} clips x "
        f"{cfg.n_sample_frames} slot frames ({n_roll / 1e6:.2f}M rollouter "
        f"parameters): step seconds {' '.join(f'{x:.3f}' for x in secs)}, "
        f"peak {peak:.2f} GiB; the first step's loss {step1:.6f} vs the "
        f"card's forward on its batch {full:.6f} (rel {rel_step:.1e}); on "
        f"{VP_CPU_CLIPS} of its clips card {part:.6f} vs CPU {ref:.6f} (rel "
        f"{rel_cpu:.1e}, tol {LOSS_RTOL:.0e}); the frozen LDM's "
        f"{len(ldm_start)} tensors " + ("bit-identical, no gradient"
                                       if not stale else
                                       f"CHANGED {stale[:3]}") + f" [{smi}]")
    if stale or not (rel_cpu <= LOSS_RTOL and rel_step <= LOSS_RTOL):
        raise SystemExit(f"{phase}: LDMSlotFormer training failed its checks")
    del ldm_start

    # the rollout of the whole videos: 3 offsets of 35 steps
    model.eval()
    cpu.rollouter.load_state_dict({k: v.cpu() for k, v in
                                   model.rollouter.state_dict().items()})
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        rolled = interleaved_rollout(slots, model.rollout, VP_OBS, hist, off)
        torch.cuda.synchronize()
        roll_s = time.time() - t0
        paths["vp_rollout"] = launch_counts()
        want = interleaved_rollout(slots[:1].cpu(), cpu.rollout, VP_OBS,
                                   hist, off)
    rel = ((rolled[:1].cpu() - want).abs().max() /
           want.abs().max()).item()
    ok = rel <= VP_ROLL_TOL and bool(torch.isfinite(rolled).all()) and \
        torch.equal(rolled[:, :VP_OBS], slots[:, :VP_OBS])
    log(f"{phase}: interleaved_rollout of {VP_VIDEOS} videos from {VP_OBS} "
        f"observed frames, frame_offset {off}: {off} offsets of "
        f"{(VP_FRAMES - VP_OBS) // off} steps in {roll_s:.2f} s wall, "
        f"launches {nonzero(paths['vp_rollout'])}; one video card vs CPU: "
        f"{rel:.2e} of its scale (tol {VP_ROLL_TOL:.0e}) "
        f"{'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise SystemExit(f"{phase}: the rollout disagrees with the CPU")
    del cpu, rolled, want

    # test_vp's path on VP_DECODE clips, the videos' frames as truth
    picks = [(i % VP_VIDEOS, (i // VP_VIDEOS) * off)
             for i in range(VP_DECODE)]
    past = torch.stack([slots[v, s:s + hist * off:off] for v, s in picks])
    gt = torch.stack([video[v, s + hist * off:s + span + 1:off]
                      for v, s in picks])
    paths["vp_decode"] = vp_decode(model, past, gt, roll, dev, gen, phase,
                                   smi)
    del model, past, gt, video, slots
    gc.collect()
    torch.cuda.empty_cache()

    # the readout: READOUT_STEPS steps at its batch, then validation
    rcfg = configs.ReadoutPhysion()
    ro = build_model(rcfg, device=dev)
    init_random_(ro, torch.Generator().manual_seed(0))
    rd, rb = rcfg.readout_dict, rcfg.train_batch_size
    sets = [SyntheticSlotsDataset(n, rd["num_slots"], rd["slot_size"],
                                  rcfg.video_len, with_labels=True, seed=i)
            for i, n in enumerate((rb * READOUT_STEPS, READOUT_VAL))]
    data = DataModule(sets[0], None, rb, rcfg.val_batch_size, seed=0)
    trainer, _, paths["readout_training"], rsecs, rpeak = fit_checked(
        ro, rcfg.copy(print_iter=1, save_interval=100.0, num_workers=0),
        data, phase, READOUT_STEPS, need=(), unit="clips of slots", smi=smi)
    data.val_set = sets[1]
    trainer.logger = JSONLLogger(None)
    ops.reset_launch_counts()
    res = trainer.validate()
    torch.cuda.synchronize()
    paths["readout_validate"] = launch_counts()
    accs = {k: v for k, v in res.items() if "/acc_" in k}
    val = next(iter(data.val_loader()))
    cpu = build_model(rcfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in ro.state_dict().items()})
    with torch.no_grad():
        a = ro({"slots": val["slots"].to(dev)})["logits"].cpu()
        b = cpu({"slots": val["slots"]})["logits"]
    rel = ((a - b).abs().max() / b.abs().max()).item()
    ok = len(accs) == 5 and all(0 <= v <= 1 for v in accs.values()) and \
        math.isfinite(res.get("val/vqa_loss", math.nan)) and \
        rel <= VP_ROLL_TOL
    log(f"{phase}: readout {READOUT_STEPS} steps at {rb} clips x "
        f"{rcfg.video_len} frames: step seconds "
        f"{' '.join(f'{x:.3f}' for x in rsecs)}, peak {rpeak:.2f} GiB; "
        f"validate over {READOUT_VAL} clips: vqa_loss "
        f"{res.get('val/vqa_loss', math.nan):.5f}, " + ", ".join(
            f"{k.removeprefix('val/')} {v:.4f}" for k, v in accs.items())
        + f"; logits card vs CPU {rel:.2e} of their scale (tol "
        f"{VP_ROLL_TOL:.0e}) {'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise SystemExit(f"{phase}: the readout failed its checks")
    del trainer, ro, cpu
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: done in {time.time() - t_phase:.1f} s [{smi}]")
    return paths

# phase 15: the trainer's optimizers and settings, and the reference .pth
# the cores beside phase 5's adam, each with its weight decay and the
# factor on the config's LRs: SGD at Adam's LR (1e-4, after the clip to a
# global norm of 0.05) moves a norm weight by less than half its f32 ulp,
# so it takes 10^4 times that
SETTINGS_OPTIMIZERS = (("adam_fused", 0.0, 1.0), ("adam_bf16", 0.0, 1.0),
                       ("adamw", 0.01, 1.0), ("adafactor", 0.0, 1.0),
                       ("sgd", 0.0, 1e4))
SETTINGS_STEPS = 3
# the steps of the blocking and the async save runs, a 1.6 GiB save after
# each (3 before the script's time took in phase 18)
SAVE_STEPS = 2
# the flagship tensors whose first update is replayed on the CPU: a
# ResBlock conv of 128 (its two largest JAX dimensions tie at 128), the
# middle ResBlock's conv of 512, an attention projection of 512 x 512
# (adafactor factors all three), the predictor's packed in-projection
# (in JAX [192, 4, 48]: not factored), the ResNet stem and a GRU bias
FIXED = ("dm_decoder.unet.input_blocks.1.0.in_layers.2.weight",
         "dm_decoder.unet.middle_block.0.in_layers.2.weight",
         "dm_decoder.unet.middle_block.1.transformer_blocks.0.attn1.to_q."
         "weight",
         "savi.predictor.transformer_encoder.layers.0.self_attn."
         "in_proj_weight",
         "savi.encoder.encoder.conv1.weight",
         "savi.slot_attention.gru.bias_ih")
UPDATE_RTOL = 1e-6
# the f32 state: torch's fused CUDA Adam forms 1 - beta2 in f32 (1.29e-5
# under 0.001, as its f32 bias correction does, which cancels it in the
# update), so its second moment sits that far from the CPU's
STATE_RTOL = 2e-5
PROFILE_OPS = ("sdt::group_norm", "sdt::mha", "sdt::sa_iterations")
PTH_CHECKS = ("encode", "denoise")


def record_first_update(trainer):
    """Wrap the trainer's core so that its first update records, for each
    `FIXED` tensor, the (clipped) gradient, its group's LR, the tensor
    before and after, and the core's state after. -> the record dict,
    filled during `fit`."""
    import torch
    core = trainer.optimizer.core
    named = dict(trainer.model.named_parameters())
    rec = {}

    def first():
        del core.step  # the class's step from the second update on
        for n in FIXED:
            p = named[n]
            lr = next(g["lr"] for g in core.param_groups
                      if any(q is p for q in g["params"]))
            rec[n] = dict(before=p.detach().cpu().clone(),
                          grad=p.grad.detach().cpu().clone(), lr=lr)
        core.step()
        for n in FIXED:
            p = named[n]
            rec[n]["after"] = p.detach().cpu().clone()
            rec[n]["state"] = {k: v.detach().cpu().clone()
                               for k, v in core.state[p].items()
                               if torch.is_tensor(v) and v.dim()}

    core.step = first
    return rec


def replay_on_cpu(name, weight_decay, rec, layouts):
    """The core `name` on the CPU from the recorded tensors, gradients and
    LRs: one update. -> {tensor name: (after, state)}."""
    import torch
    from slotdiffusion_tpu_torch.training.optim import build_core
    params = {n: torch.nn.Parameter(r["before"].clone())
              for n, r in rec.items()}
    core = build_core(
        name, [{"params": [params[n]], "lr": rec[n]["lr"]} for n in rec],
        weight_decay, {params[n]: layouts.get(n) for n in rec})
    for n, p in params.items():
        p.grad = rec[n]["grad"].clone()
    core.step()
    return {n: (p.detach(), {k: v for k, v in core.state[p].items()
                             if torch.is_tensor(v) and v.dim()})
            for n, p in params.items()}


def bf16_ulps(a, b):
    """The largest difference of two bf16 tensors in ulps of the larger
    magnitude of each pair."""
    import torch
    big = torch.maximum(a.float().abs(), b.float().abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
    return ((a.float() - b.float()).abs() / ulp).max().item()


def compare_first_update(card, cpu, phase, what):
    """The card's first update against the CPU's: each tensor after it
    within `UPDATE_RTOL` of its largest value, each f32 state tensor
    within `STATE_RTOL` of its largest, each bf16 one within one bf16
    ulp; each tensor or state entry outside that logged with its worst
    element. -> whether all held."""
    import torch
    worst, ok = [0.0, 0.0, 0.0], True
    for n, (after, state) in cpu.items():
        pairs = [("tensor", card[n]["after"], after)] + [
            (k, card[n]["state"][k], v) for k, v in state.items()]
        for k, c, v in pairs:
            if v.dtype == torch.bfloat16:
                err, slot, tol = bf16_ulps(c, v), 2, 1.0
            else:
                err = ((c - v).abs().max() / v.abs().max().clamp_min(
                    1e-30)).item()
                slot, tol = (0, UPDATE_RTOL) if k == "tensor" else (
                    1, STATE_RTOL)
            worst[slot] = max(worst[slot], err)
            if err <= tol:
                continue
            ok = False
            i = int((c.float() - v.float()).abs().argmax())
            g = card[n]["grad"].flatten()[i].item()
            log(f"{phase}: {what}: {n} {k} off by {err:.3e} (tol "
                f"{tol:.0e}): worst element {i}: card "
                f"{c.flatten()[i].item():.9e}, CPU "
                f"{v.flatten()[i].item():.9e}, gradient {g:.9e}, largest "
                f"{v.float().abs().max().item():.3e}, elements off "
                f"{int(((c.float() - v.float()).abs() > tol * v.float().abs().max()).sum())} "
                f"of {v.numel()}")
    log(f"{phase}: {what}: first update card vs CPU on {len(cpu)} tensors: "
        f"tensors {worst[0]:.2e} (tol {UPDATE_RTOL:.0e} relative), f32 "
        f"state {worst[1]:.2e} (tol {STATE_RTOL:.0e}), bf16 state "
        f"{worst[2]:.0f} ulp (tol 1) {'ok' if ok else 'FAIL'}")
    return ok


def settings_fit(model, tcfg, data, phase, label, ckp_path=None):
    """`build_method` on the settings `tcfg`, its logger a `StepReport`.
    -> (trainer, report)."""
    from slotdiffusion_tpu_torch.methods.build import build_method
    # phase 16 draws the epoch-end visualisation: use_viz off here
    trainer = build_method(model, data, tcfg.copy(use_viz=False),
                           ckp_path=ckp_path)
    trainer.logger = report = StepReport(f"{phase} {label}")
    return trainer, report


def run_fit(trainer, report, phase, label):
    """`Trainer.fit()` (the config's `max_steps` ends it): finite losses,
    the three kernels launched in every step. -> ({kernel: launches} over
    the steps, fit seconds on the host clock, peak GiB)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.time()
    trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 2.0 ** 30
    totals = dict.fromkeys(launch_counts(), 0)
    for st in report.steps:
        check_launches(st["launches"], f"{phase} {label}: a step", False)
        for k, n in st["launches"].items():
            totals[k] += n
    losses = [st["train/total_loss"] for st in report.steps]
    if len(losses) != trainer.max_steps or \
            not all(map(math.isfinite, losses)):
        raise SystemExit(f"{phase} {label}: losses {losses}")
    return totals, fit_s, peak


def settings(smi, dev, phase="phase 15"):
    """Phase 15: the JAX trainer's optimizers and settings on the flagship
    at full width (32 clips x 6 frames, f32, random weights): each core
    of `SETTINGS_OPTIMIZERS` trains `SETTINGS_STEPS` steps through
    `Trainer.fit` and the config's `max_steps` (step seconds, peak memory,
    the state's bytes, every trainable tensor moved, the frozen VQ-VAE
    bit-identical, the first update against the CPU's); 3 steps with a
    save after each, blocking then async (the seconds the loop blocked,
    the last file bit-identical); a torch.profiler trace of 2 steps (it
    must name the three kernels' `sdt::` operators); the reference-layout
    `.pth` round trip through scripts/convert_checkpoint_torch.py into a
    fresh model, whose graphed `encode` and `denoise` must equal the
    original's bit for bit. -> {path: {kernel: launches}}."""
    import gc
    import importlib.util
    import tempfile

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.convert import export_reference_state_dict
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticVideoData
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.serving import build_serving_fn
    from slotdiffusion_tpu_torch.training.checkpoint import load_checkpoint
    from slotdiffusion_tpu_torch.training.optim import flax_layouts

    t_phase = time.time()
    cfg = configs.SAViLDMMoviE128()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    init = {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}
    layouts = flax_layouts(model)
    batch = cfg.train_batch_size
    # no warmup (the first update at the full LR), a log line every step,
    # no mid-run save; max_steps ends each run
    base = cfg.copy(max_steps=SETTINGS_STEPS, print_iter=1,
                    warmup_steps_pct=0.0, save_interval=1000.0,
                    save_epoch_end=False)
    data = SyntheticVideoData(base, batch, num_samples=4 * batch, seed=0)
    paths = {"settings_optimizers": dict.fromkeys(launch_counts(), 0)}
    failed = []  # checks that failed; the phase runs on and raises last
    for name, wd, lr_x in SETTINGS_OPTIMIZERS:
        model.load_state_dict(init)
        tcfg = base.copy(optimizer=name, weight_decay=wd, lr=cfg.lr * lr_x,
                         dec_lr=cfg.dec_lr * lr_x)
        trainer, report = settings_fit(model, tcfg, data, phase, name)
        vae = {n: p.detach().clone()
               for n, p in model.dm_decoder.vae.named_parameters()}
        start = {n: p.detach().clone() for n, p in model.named_parameters()
                 if p.requires_grad}
        rec = record_first_update(trainer)
        counts, fit_s, peak = run_fit(trainer, report, phase, name)
        for k, n in counts.items():
            paths["settings_optimizers"][k] += n
        secs = [st["step_seconds"] for st in report.steps]
        still = [n for n, p in model.named_parameters()
                 if n in start and torch.equal(p, start[n])]
        if name == "sgd":
            # SGD's last update is the LR times its trace: a tensor where
            # that stays below each element's f32 ulp (eps |p| bounds it)
            # cannot move; every other one must
            core, named = trainer.optimizer.core, dict(
                model.named_parameters())
            lr_of = {id(p): g["lr"] for g in core.param_groups
                     for p in g["params"]}
            small = [n for n in still if not (
                (core.state[named[n]]["momentum_buffer"] *
                 lr_of[id(named[n])]).abs() >=
                torch.finfo(torch.float32).eps * named[n].abs()).any()]
            still = [n for n in still if n not in small]
            log(f"{phase}: sgd: {len(small)} trainable tensors' last "
                f"update stays under their f32 ulp: {small[:4]}")
        vae_moved = [n for n, p in model.dm_decoder.vae.named_parameters()
                     if not torch.equal(p, vae[n])]
        state_bytes = trainer.optimizer.state_bytes()
        n_bytes = sum(p.numel() * 4 for p in start.values())
        log(f"{phase}: {name}{f' (weight_decay {wd})' if wd else ''}"
            f"{f' at {lr_x:g}x the LRs' if lr_x != 1 else ''}: "
            f"{trainer.optimizer.name} core, Trainer.fit() to max_steps "
            f"{SETTINGS_STEPS} at {batch} clips took {fit_s:.1f}s, steps "
            + " ".join(f"{x:.3f}" for x in secs) + " s, median of steps "
            f"2-3 {statistics.median(secs[1:]):.3f} s, max allocated "
            f"{peak:.2f} GiB, optimizer state {state_bytes / 2.0 ** 30:.3f}"
            f" GiB ({state_bytes / n_bytes:.3f}x the trainable f32 "
            f"tensors), launches {counts} [{smi}]")
        if still or vae_moved:
            log(f"{phase}: {name}: {len(still)} trainable tensors did not "
                f"move ({still[:4]}), the frozen VQ-VAE moved in "
                f"{vae_moved[:4]}: FAIL")
            failed.append(f"{name}'s tensors")
        else:
            log(f"{phase}: {name}: all {len(start)} trainable tensors moved,"
                " the frozen VQ-VAE is bit-identical")
        del trainer, report, start, vae
        gc.collect()
        torch.cuda.empty_cache()
        if not compare_first_update(
                rec, replay_on_cpu(name, wd, rec, layouts), phase, name):
            failed.append(f"{name}'s first update")
        # adam_fused: the same update as adam's (the JAX fused_adam is
        # optax.adam)
        if name == "adam_fused" and not compare_first_update(
                rec, replay_on_cpu("adam", 0.0, rec, layouts), phase,
                "adam_fused against adam"):
            failed.append("adam_fused against adam")
        del rec

    # async against blocking saves: SAVE_STEPS steps, a save after each
    blocked = {}
    paths["settings_async_ckpt"] = dict.fromkeys(launch_counts(), 0)
    for flag in (False, True):
        model.load_state_dict(init)
        tcfg = base.copy(async_ckpt=flag, save_interval=1.0 / len(data),
                         max_steps=SAVE_STEPS)
        with tempfile.TemporaryDirectory() as tmp:
            label = f"async_ckpt={flag}"
            trainer, report = settings_fit(model, tcfg, data, phase, label,
                                           ckp_path=tmp)
            counts, fit_s, _ = run_fit(trainer, report, phase, label)
            for k, n in counts.items():
                paths["settings_async_ckpt"][k] += n
            steps_s = sum(st["step_seconds"] for st in report.steps)
            blocked[flag] = fit_s - steps_s
            path = os.path.join(tmp, "ckpt_last.pt")
            size = os.path.getsize(path) / 2.0 ** 30
            last = load_checkpoint(path)
            same = last["step"] == SAVE_STEPS and all(
                torch.equal(last["model"][k], v.cpu())
                for k, v in model.state_dict().items())
            log(f"{phase}: {label}: {SAVE_STEPS} steps with a save of "
                f"{size:.2f} GiB "
                f"after each: fit {fit_s:.2f}s, the steps {steps_s:.2f}s, "
                f"the loop blocked {blocked[flag]:.2f}s outside the steps; "
                f"ckpt_last reloads bit-identical to the live model: "
                f"{'ok' if same else 'FAIL'} [{smi}]")
            if not same:
                failed.append(f"{label}'s ckpt_last")
            del trainer, report, last
        gc.collect()
        torch.cuda.empty_cache()
    log(f"{phase}: async saves blocked the loop {blocked[True]:.2f}s "
        f"against {blocked[False]:.2f}s blocking")

    # a trace of 2 steps
    model.load_state_dict(init)
    with tempfile.TemporaryDirectory() as tmp:
        tcfg = base.copy(max_steps=2, profile_dir=tmp, profile_steps=(0, 2))
        trainer, report = settings_fit(model, tcfg, data, phase, "profile")
        paths["settings_profile"], fit_s, _ = run_fit(trainer, report,
                                                      phase, "profile")
        path = os.path.join(tmp, "trace_steps0-2.json")
        with open(path) as f:
            text = f.read()
        named = {op: text.count(f'"{op}"') for op in PROFILE_OPS}
        kernels = text.count('"cat": "kernel"')
        log(f"{phase}: torch.profiler trace of micro-steps [0, 2): "
            f"{os.path.getsize(path) / 2.0 ** 20:.1f} MiB, fit {fit_s:.1f}s;"
            f" the operators' names {named} times in it; {kernels} device "
            "kernel events")
        if not all(named.values()):
            failed.append(f"the trace's operators {named}")
        del trainer, report, text
    gc.collect()
    torch.cuda.empty_cache()

    # the reference-layout .pth round trip, through the converter script
    spec = importlib.util.spec_from_file_location(
        "convert_checkpoint_torch", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "scripts",
            "convert_checkpoint_torch.py"))
    convert = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(convert)
    with tempfile.TemporaryDirectory() as tmp:
        sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
        ref = {f"module.{k}": v for k, v in
               export_reference_state_dict(sd, cfg).items()}
        ref["module.loss.perceptual_loss.lin0.model.1.weight"] = \
            torch.ones(1, 64, 1, 1)
        src, out = os.path.join(tmp, "ref.pth"), os.path.join(tmp, "m.pt")
        torch.save({"state_dict": ref}, src)
        t0 = time.time()
        if convert.main(["--params", "SAViLDMMoviE128", "--weight", src,
                         "--out", out]) != 0:
            raise SystemExit(f"{phase}: the converter failed")
        conv_s = time.time() - t0
        fresh = build_model(cfg, device=dev)
        fresh.load_state_dict(load_checkpoint(out)["model"], strict=True)
    del sd, ref
    model.eval()
    fresh.eval()
    same_sd = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), fresh.state_dict().values()))
    video, x_t, t_model = serving_inputs(cfg, dev)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        outs, counts = {}, dict.fromkeys(launch_counts(), 0)
        for which, m in (("original", model), ("converted", fresh)):
            encode, denoise = (build_serving_fn(m, s) for s in PTH_CHECKS)
            slots, masks = encode(video)
            d = denoise(x_t, t_model, slots)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            slots, masks = encode(video)  # replays, counted
            d = denoise(x_t, t_model, slots)
            torch.cuda.synchronize()
            for k, n in launch_counts().items():
                counts[k] += n
            outs[which] = (slots, masks, d)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = [torch.equal(a, b) for a, b in zip(outs["original"],
                                                outs["converted"])]
    log(f"{phase}: the flagship through export_reference_state_dict, a "
        f"DDP-wrapped .pth with an LPIPS head, and convert_checkpoint_torch"
        f".py ({conv_s:.1f}s) into a fresh model: state_dict "
        f"{'identical' if same_sd else 'DIFFERS'}; graphed encode slots, "
        f"masks and denoise bit-identical {same}; launches {counts}")
    check_launches(counts, f"{phase}: the .pth round trip", False)
    if not (same_sd and all(same)):
        failed.append("the converted model")
    paths["settings_pth"] = counts
    del model, fresh, outs
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: took {time.time() - t_phase:.1f}s")
    if failed:
        raise SystemExit(f"{phase}: {failed}")
    return paths


# phase 16: what evaluation lacked until now, on the flagship at full width
# (random weights, seed 0). Compositional generation of EVAL_VIDEOS
# in-memory videos of EVAL_FRAMES frames (I3D takes >= 9): their slots
# shuffled across the videos and decoded by DPM-Solver++ (20 steps) and
# the VQ decode, one video held against the plain twin from the same x_T
# as phase 14's decode (CODE_AGREE, SAME_CODE_TOL, every UNet call
# replayed within PER_CALL_TOL). FID and FVD on seeded stand-in networks
# (`save_random_inception_npz`, `save_random_i3d_npz`, the converter's
# arrays of the same state dicts bit for bit): the features of the
# composed and real frames at 299 x 299 (clips at 224 x 224) on the card
# against the CPU within EVAL_FEATURE_TOL of their scale: f32 convolutions
# (TF32 off) whose sums cuDNN takes in another order, and may take by
# Winograd or FFT, through ~20 layers. test_recon's loop over
# RECON_BATCHES batches of those clips with LPIPS, FID and FVD, then again
# over its cache (no kernel, the same FINAL line). The viz callbacks
# (the flagship's ancestral chain over 2 videos x 6 frames, SA's image
# grids) and one `Trainer.validate` that draws them.
EVAL_VIDEOS, EVAL_FRAMES, VIZ_FRAMES, RECON_BATCHES = 2, 16, 6, 2
EVAL_FEATURE_TOL = 1e-3
VIZ_STEP = 7
# the flagship's viz samples with DPM-Solver++ (20 UNet calls) here, not
# its config's 1000-step chain: the script's time limit (phase 17)
VIZ_DPM = True


def card_vs_cpu(fn, x, what, unit, phase):
    """`fn` (a feature function) on `x` on the card, timed after a warm
    call on the same items, against the CPU. -> (features on the card, ms
    an item)."""
    import torch
    fn(x)
    torch.cuda.synchronize()
    t0 = time.time()
    card = fn(x)
    torch.cuda.synchronize()
    ms = 1e3 * (time.time() - t0) / len(x)
    cpu = fn(x.cpu())
    rel = ((card.cpu() - cpu).abs().max() / cpu.abs().max()).item()
    ok = rel <= EVAL_FEATURE_TOL and bool(torch.isfinite(card).all())
    log(f"{phase}: {what} of {len(x)} {unit} {tuple(card.shape)}: "
        f"{ms:.2f} ms a{'n' if unit[0] in 'aeiou' else ''} "
        f"{unit.rstrip('s')} on the card (host clock, after a warm call); "
        f"card vs CPU {rel:.2e} of their scale (tol "
        f"{EVAL_FEATURE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{phase}: {what} on the card disagrees with the "
                         "CPU")
    return card, ms


def read_back(path, shape, frames=1):
    """A PNG / APNG the port wrote, read by its own reader: -> True if it
    holds `frames` frames of `shape`."""
    from slotdiffusion_tpu_torch.utils.png import read_png
    data, _ = read_png(path)
    return data.shape == (frames, *shape) and data.dtype.name == "uint8"


def evaluation(smi, dev, gen, phase="phase 16"):
    """Phase 16: compositional generation, native FID and FVD, test_recon
    with LPIPS and its cache, frame dumps and the epoch-end visualisation
    on the flagship at full width. -> {path: launches}."""
    import gc
    import tempfile

    import numpy as np
    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.methods.comp_gen import (decode_slots,
                                                          encode_slots,
                                                          shuffle_slots)
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.models.diffusion import noise_like
    from slotdiffusion_tpu_torch.ops import fid, fvd, lpips
    from slotdiffusion_tpu_torch.utils.png import read_png, save_image, \
        to_uint8
    t_phase, secs, paths = time.time(), {}, {}
    cfg = configs.SAViLDMMoviE128()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    model.eval()
    dm, (H, W) = model.dm_decoder, cfg.resolution
    B, T, S = EVAL_VIDEOS, EVAL_FRAMES, cfg.slot_dict["num_slots"]
    g = torch.Generator(device=dev).manual_seed(16)
    video = torch.rand(B, T, H, W, 3, generator=g, device=dev) * 2 - 1

    # ---- compositional generation: encode, shuffle, decode --------------
    shapes, handles = record_shapes(model)
    with torch.inference_mode():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        slots = encode_slots(model, cfg, video)
        torch.cuda.synchronize()
        secs["encode"] = time.time() - t0
        paths["comp_gen_encode"] = launch_counts()
    for hk in handles:
        hk.remove()
    unet_launches(paths["comp_gen_encode"], 0, T, f"{phase}: encode")
    check_kernels(shapes, model.savi.slot_attention, gen, dev,
                  f"{phase} (encode shapes)", timing=False)
    mixed = shuffle_slots(slots)
    exact = mixed.shape == slots.shape and all(
        torch.equal(mixed[b, :, k], slots[(b - k) % B, :, k])
        for b in range(B) for k in range(S))
    log(f"{phase}: encode of {B} videos x {T} frames of {H}x{W}: "
        f"{secs['encode']:.2f} s, launches "
        f"{nonzero(paths['comp_gen_encode'])}; shuffle_slots: slot k of "
        f"video b is slot k of video (b - k) mod {B} for all {S} slots "
        f"{'exactly' if exact else 'NOT'}")
    if not exact:
        raise SystemExit(f"{phase}: shuffle_slots moved the wrong slots")
    x_T = noise_like(g, (B * T, *dm.resolution, dm.channels), True, dev)
    z = []
    shapes, handles = record_shapes(model)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with torch.inference_mode(), unet_calls(dm, [0]) as calls, \
            sampled_latents(dm, z):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        start.record()
        frames = decode_slots(model, cfg, mixed, x_T=x_T).float()
        end.record()
        torch.cuda.synchronize()
        secs["decode"] = time.time() - t0
        paths["comp_gen_decode"] = launch_counts()
    for hk in handles:
        hk.remove()
    unet_launches(paths["comp_gen_decode"], len(calls), 0,
                  f"{phase}: decode")
    check_kernels(shapes, None, gen, dev, f"{phase} (decode shapes)",
                  timing=False)
    ok, verdict = dpm_twin(dm, z[0][:T], mixed.reshape(B * T, S, -1)[:T],
                           x_T[:T], calls, frames[:T])
    ok = ok and frames.shape == (B * T, H, W, 3) and \
        bool(torch.isfinite(frames).all())
    log(f"{phase}: decode_slots of the composed slots: {len(calls)} UNet "
        f"calls, {secs['decode']:.2f} s wall, {start.elapsed_time(end):.1f} "
        f"ms CUDA events, launches {nonzero(paths['comp_gen_decode'])}, "
        f"frames {tuple(frames.shape)}; the first video against {verdict} "
        f"{'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise SystemExit(f"{phase}: the composed video disagrees with its "
                         "plain twin")
    del z, calls

    env = {}
    with tempfile.TemporaryDirectory() as tmp:
        # ---- the seeded stand-in networks, and their converters ----------
        for name, mod, make, fold_save in (
                ("inception", fid, fid.random_inception_state_dict,
                 fid.save_random_inception_npz),
                ("i3d", fvd, fvd.random_i3d_state_dict,
                 fvd.save_random_i3d_npz)):
            pth = os.path.join(tmp, f"{name}.pth")
            torch.save(make(0), pth)
            convert = fid.convert_torch_inception_npz if mod is fid else \
                fvd.convert_torch_i3d_npz
            conv = convert(pth, os.path.join(tmp, f"{name}_converted.npz"))
            env[mod.WEIGHTS_ENV] = fold_save(os.path.join(tmp, f"{name}.npz"))
            with np.load(conv) as a, np.load(env[mod.WEIGHTS_ENV]) as b:
                same = set(a.files) - set(b.files) == {
                    "__source_sha256__"} and all(
                    (a[k] == b[k]).all() for k in b.files)
            log(f"{phase}: {name}: the converter's .npz of the seeded "
                f"state dict equals the stand-in's array for array "
                f"{'ok' if same else 'FAIL'}")
            if not same:
                raise SystemExit(f"{phase}: the {name} converter disagrees")
        env[lpips.WEIGHTS_ENV] = lpips.save_random_lpips_npz(
            os.path.join(tmp, "lpips.npz"), seed=0)
        saved = {k: os.environ.get(k) for k in env}
        os.environ.update(env)
        try:
            secs.update(metrics_and_recon(
                cfg, model, video, frames, dev, smi, tmp, paths, phase))
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        # a frame written and read back by the port's PNG writer and reader
        frame = to_uint8(frames[0] * 0.5 + 0.5)
        back, _ = read_png(save_image(frame, os.path.join(tmp, "f.png")))
        if not (back[0] == frame).all():
            raise SystemExit(f"{phase}: a PNG did not read back as written")
    del video, frames, slots, mixed, x_T
    gc.collect()
    torch.cuda.empty_cache()

    # ---- the epoch-end visualisation ------------------------------------
    with tempfile.TemporaryDirectory() as tmp:
        secs.update(visualise(cfg, model, dev, smi, tmp, paths, phase))
    del model
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: done in {time.time() - t_phase:.1f} s: " + ", ".join(
        f"{k} {v:.2f} {'ms' if '_ms_' in k else 's'}"
        for k, v in secs.items()) + f" [{smi}]")
    return paths


def metrics_and_recon(cfg, model, video, frames, dev, smi, tmp, paths,
                      phase):
    """FID and FVD of the composed frames, then test_recon's loop cold and
    warm, with the stand-in networks the environment names. -> {part:
    seconds}."""
    import contextlib as ctx
    import io

    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.methods.evaluation import (feature_fns,
                                                            recon_eval)
    from slotdiffusion_tpu_torch.ops import fid, fvd
    secs = {}
    B, T, (H, W) = EVAL_VIDEOS, EVAL_FRAMES, cfg.resolution
    composed = (frames * 0.5 + 0.5).clamp(0, 1)
    real = (video.float() * 0.5 + 0.5).clamp(0, 1).reshape(B * T, H, W, 3)
    feats = {}
    for what, x in (("composed", composed), ("real", real)):
        feats[what], secs[f"fid_ms_per_{what}_image"] = card_vs_cpu(
            fid.inception_pool3_features, x, f"pool3 features ({what})",
            "images", phase)
    t0 = time.time()
    value = fid.fid_from_features(feats["composed"].cpu().numpy(),
                                  feats["real"].cpu().numpy())
    secs["fid_distance"] = time.time() - t0
    label = fid.weights_label("fid")
    log(f"{phase}: {label} of {B * T} composed vs {B * T} real frames at "
        f"299x299: {value:.4f} (the Frechet distance "
        f"{secs['fid_distance']:.2f} s on the host) [{smi}]")
    if label != "fid(untrained-weights)" or not math.isfinite(value):
        raise SystemExit(f"{phase}: FID {label} = {value}")
    clips = {}
    for what, x in (("composed", composed), ("real", real)):
        clips[what], secs[f"fvd_ms_per_{what}_clip"] = card_vs_cpu(
            fvd.i3d_features, x.reshape(B, T, H, W, 3),
            f"I3D features ({what})", "clips", phase)
    value = fvd.fvd_from_features(clips["composed"].cpu().numpy(),
                                  clips["real"].cpu().numpy())
    label = fvd.weights_label("fvd")
    log(f"{phase}: {label} of {B} composed vs {B} real clips of {T} frames "
        f"at 224x224: {value:.4f} [{smi}]")
    if label != "fvd(untrained-weights)" or not math.isfinite(value):
        raise SystemExit(f"{phase}: FVD {label} = {value}")

    # ---- test_recon, cold then warm -------------------------------------
    g = torch.Generator(device=dev).manual_seed(17)
    batches = [{"img": video.cpu()}] + [
        {"img": (torch.rand(B, T, H, W, 3, generator=g, device=dev) * 2 - 1
                 ).cpu()} for _ in range(RECON_BATCHES - 1)]
    cache = os.path.join(tmp, "recon", f"{cfg.__class__.__name__}.metrics.pkl")
    frames_dir = os.path.join(tmp, "frames")
    fid_fn, fvd_fn = feature_fns(True, True)
    runs = {}
    for run in ("cold", "warm"):
        out = io.StringIO()
        with torch.inference_mode(), unet_calls(model.dm_decoder, [0]) as \
                calls, ctx.redirect_stdout(out):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.time()
            final = recon_eval(model, cfg, batches, cache, dev, fid_fn,
                               fvd_fn, frames_dir=frames_dir if run == "cold"
                               else "", total=len(batches))
            torch.cuda.synchronize()
            secs[f"test_recon_{run}"] = time.time() - t0
            counts = launch_counts()
        paths[f"test_recon_{run}"] = counts
        text = out.getvalue()
        print(text, end="", flush=True)
        finals = [ln for ln in text.splitlines() if ln.startswith("FINAL ")]
        runs[run] = (final, finals, len(calls), counts)
    (cold, cold_line, n_calls, counts), (warm, warm_line, warm_calls,
                                         warm_counts) = runs.values()
    unet_launches(counts, n_calls, RECON_BATCHES * T,
                  f"{phase}: test_recon (cold)")
    keys = {"mse", "psnr", "ssim", "lpips(untrained-weights)",
            "fid(untrained-weights)", "fvd(untrained-weights)"}
    dumps = sorted(os.listdir(frames_dir))
    read = all(read_back(os.path.join(frames_dir, f), (H, W, 3))
               for f in dumps)
    ok = (set(cold) == keys and all(math.isfinite(v) for v in cold.values())
          and len(cold_line) == 1 and warm_line == cold_line and warm == cold
          and warm_calls == 0 and not any(warm_counts.values())
          and len(dumps) == RECON_BATCHES * B * T and read)
    log(f"{phase}: test_recon over {RECON_BATCHES} batches of {B} clips x "
        f"{T} frames: cold {secs['test_recon_cold']:.2f} s ({n_calls} UNet "
        f"calls, launches {nonzero(counts)}), warm over its cache "
        f"{secs['test_recon_warm']:.2f} s ({warm_calls} UNet calls, launches "
        f"{nonzero(warm_counts) or 'none'}); the same FINAL line "
        f"{'yes' if warm_line == cold_line else 'NO'}: "
        f"{cold_line[0] if cold_line else None}; {len(dumps)} frame dumps "
        f"{'read back' if read else 'DO NOT read back'} through the port's "
        f"PNG reader {'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise SystemExit(f"{phase}: test_recon's cache, keys or dumps are "
                         "wrong")
    return secs


def visualise(cfg, model, dev, smi, tmp, paths, phase):
    """The flagship's video viz (through DPM-Solver++, VIZ_DPM: its
    config's sampler, the 1000-step ancestral chain, took 30-43 s here and
    phase 10 runs that chain) and SA's image viz called directly, then one
    `Trainer.validate` of SA that draws its viz. -> {part: seconds}."""
    import types

    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import SyntheticImageDataset
    from slotdiffusion_tpu_torch.methods import viz
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    secs, (H, W) = {}, cfg.resolution
    g = torch.Generator(device=dev).manual_seed(18)
    clips = torch.rand(EVAL_VIDEOS, VIZ_FRAMES, H, W, 3, generator=g,
                       device=dev) * 2 - 1
    vcfg = cfg.copy(use_dpm=VIZ_DPM)
    fake = types.SimpleNamespace(params=vcfg, model=model, device=dev,
                                 logger=types.SimpleNamespace())
    vdir = os.path.join(tmp, "video")
    with unet_calls(model.dm_decoder, [0]) as calls:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.time()
        viz.build_viz_fn(vcfg)(fake, {"img": clips.cpu()}, {}, VIZ_STEP,
                               vdir)
        torch.cuda.synchronize()
        secs["viz_video"] = time.time() - t0
        paths["viz_video"] = launch_counts()
    n_calls = len(calls)
    del calls
    unet_launches(paths["viz_video"], n_calls, VIZ_FRAMES,
                  f"{phase}: viz (video)")
    stem = os.path.join(vdir, f"step{VIZ_STEP}_video_samples")
    dm = model.dm_decoder
    want_calls = dm.dpm_steps if VIZ_DPM else dm.num_timesteps
    ok = n_calls == want_calls and read_back(
        stem + ".png", (3 * H + 4, VIZ_FRAMES * W, 3)) and read_back(
        stem + ".apng", (H, W, 3), VIZ_FRAMES)
    log(f"{phase}: the flagship's viz (use_dpm {vcfg.use_dpm}) on "
        f"{EVAL_VIDEOS} videos x {VIZ_FRAMES} frames: "
        f"{secs['viz_video']:.2f} s, {n_calls} UNet calls, launches "
        f"{nonzero(paths['viz_video'])}; its grid and APNG read back "
        f"{'ok' if ok else 'FAIL'} [{smi}]")
    if not ok:
        raise SystemExit(f"{phase}: the video viz is wrong")

    scfg = configs.SACLEVRTex128()
    sa = build_model(scfg, device=dev)
    init_random_(sa, torch.Generator().manual_seed(0))
    sa.eval()
    n, S = IMG_SERVE, scfg.slot_dict["num_slots"]
    imgs = torch.rand(n, *scfg.resolution, 3, generator=g, device=dev) * 2 - 1
    fake = types.SimpleNamespace(params=scfg, model=sa, device=dev,
                                 logger=types.SimpleNamespace())
    idir = os.path.join(tmp, "image")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    with torch.no_grad():
        out = sa({"img": imgs})
    viz.build_viz_fn(scfg)(fake, {"img": imgs.cpu()}, out, VIZ_STEP, idir)
    torch.cuda.synchronize()
    secs["viz_image"] = time.time() - t0
    paths["viz_image"] = launch_counts()
    unet_launches(paths["viz_image"], 0, 1, f"{phase}: viz (image)")
    h, w = scfg.resolution
    grid = (3 * h + 4, n * w, 3)
    ok = read_back(os.path.join(idir, f"step{VIZ_STEP}_recon.png"), grid) \
        and read_back(os.path.join(idir, f"step{VIZ_STEP}_slots.png"),
                      (h, S * w, 3))
    log(f"{phase}: SA's viz (`SACLEVRTex128`) of {n} images: "
        f"{secs['viz_image']:.2f} s with the encode, launches "
        f"{nonzero(paths['viz_image'])}; its grids read back "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{phase}: the image viz is wrong")

    # one validate with a checkpoint directory and use_viz on
    data = DataModule(SyntheticImageDataset(scfg.resolution, n, seed=0),
                      SyntheticImageDataset(scfg.resolution, n, seed=1),
                      n, n, seed=0)
    ckp = os.path.join(tmp, "run")
    trainer = build_method(sa, data, scfg.copy(num_workers=0,
                                               val_batch_size=n),
                           ckp_path=ckp)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.time()
    res = trainer.validate(max_steps=1)
    torch.cuda.synchronize()
    secs["validate_with_viz"] = time.time() - t0
    paths["viz_validate"] = launch_counts()
    vz = os.path.join(ckp, "viz")
    files = sorted(os.listdir(vz)) if os.path.isdir(vz) else []
    ok = files == ["step0_recon.png", "step0_slots.png"] and read_back(
        os.path.join(vz, files[0]), grid) and read_back(
        os.path.join(vz, files[1]), (h, S * w, 3)) and \
        paths["viz_validate"]["slot_attention"] == 1 and \
        math.isfinite(res.get("val/img_recon_loss", math.nan))
    log(f"{phase}: Trainer.validate of SA with ckp_path and use_viz: "
        f"{secs['validate_with_viz']:.2f} s, launches "
        f"{nonzero(paths['viz_validate'])}, {files} read back "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"{phase}: validate drew no viz, or a wrong one")
    del trainer, sa
    return secs


# phase 17: scale-out and cross-device export (see the module docstring)
SCALE_STEPS, SCALE_CLIPS, GLOO_RANKS = 3, 4, 2
# the ranks' losses against one process on the same global batch: the
# batch is split, so cuBLAS and cuDNN may take other algorithms and sum
# in another order; the worst reading was 4.12e-06 (2 gloo ranks on one
# card) and 3.51e-06 (TP 2 x 2 on four), so about 12x that
SCALE_LOSS_RTOL = 5e-5
# each run's trained state (rank 0's ckpt_last: parameters, EMA, Adam's
# moments) against the one process's, each kind within this share of its
# largest value (`state_distance`), as the CPU tests' STATE_TOL: the
# warm-up's small LR hides a gradient left unsynchronised (or summed, not
# averaged) from the losses, not from Adam's moments
SCALE_STATE_TOL = 1e-3
# the CPU side of the cross-device export: a process that sees no card
# builds the flagship (seed 0) and exports each surface for `cuda`
CROSS_EXPORT = r"""
import json, os, sys, time
sys.path.insert(0, sys.argv[1])
import torch
assert not torch.cuda.is_available(), "the exporting process sees a card"
from slotdiffusion_tpu_torch import configs, serving
from slotdiffusion_tpu_torch.models import build_model, init_random_
cfg = configs.SAViLDMMoviE128()
model = build_model(cfg, device="cpu")
init_random_(model, torch.Generator().manual_seed(0))
secs = {}
for what in ("encode", "sample"):
    fn, example = serving.build_serving_fn(
        model, what, serving.data_shape(cfg, 2))
    t = time.time()
    serving.save_artifact(os.path.join(sys.argv[2], what + "_cpu.pt2"), fn,
                          example, devices=("cuda",))
    secs[what] = time.time() - t
print("CROSS_EXPORT " + json.dumps(secs), flush=True)
"""


def scale_fit(dev, spec, mesh, label):
    """The flagship (seed 0) trained SCALE_STEPS steps of `spec["clips"]`
    global clips through `build_method` on `mesh` (None: one process),
    with a `StepReport` logger on every rank. -> (trainer, report)."""
    import torch
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.parallel import data_coords
    cfg = configs.SAViLDMMoviE128().copy(
        print_iter=1, max_steps=SCALE_STEPS, use_viz=False,
        async_ckpt=False, save_interval=100.0, save_epoch_end=False,
        train_batch_size=spec["clips"], fsdp=spec.get("fsdp", False))
    t0 = time.time()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    train, _ = synthetic_video_splits(cfg, spec["clips"] * SCALE_STEPS, 0)
    index, count = data_coords(mesh)
    data = DataModule(train, None, spec["clips"], seed=0,
                      process_index=index, process_count=count)
    trainer = build_method(model, data, cfg, ckp_path=spec.get("ckp"),
                           mesh=mesh)
    trainer.logger = report = StepReport(label)
    torch.cuda.synchronize()
    t1 = time.time()
    ops.reset_launch_counts()
    trainer.fit(san_check_val_step=0)
    log(f"{label}: built, initialised and laid out in {t1 - t0:.1f}s, "
        f"fit (with its ckpt_last) {time.time() - t1:.1f}s")
    return trainer, report


def allreduce_ms(numel, dev, reps=5):
    """CUDA-event ms of one all-reduce of `numel` f32 values over the
    default group, the median of `reps` after a warm-up."""
    import torch
    import torch.distributed as dist
    buf = torch.ones(numel, device=dev)
    dist.all_reduce(buf)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        start.record()
        dist.all_reduce(buf)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[reps // 2]


def scale_rank(rank, world, port, spec):
    """One rank of a phase 17 run (spawned by `torch.multiprocessing`):
    joins the group through `maybe_initialize_distributed` from
    torchrun's variables (NCCL on the card of its local rank; gloo with
    CUDA tensors where `spec["backend"]` says so), trains, checks its
    launches in every step, and writes its result as JSON."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # torchrun's variables, and the explicit opt-in that a one-rank run
    # needs (WORLD_SIZE 1 is a single process to the detection)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank % torch.cuda.device_count()),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      SLOTDIFFUSION_MULTIHOST="1")
    from slotdiffusion_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed)
    gloo = spec["backend"] == "gloo"
    if gloo:  # every rank on the one card
        torch.cuda.set_device(0)
    if not maybe_initialize_distributed(cpu=gloo, verbose=False):
        raise SystemExit(f"rank {rank}: no multi-process launch detected")
    if dist.get_backend() != spec["backend"]:
        raise SystemExit(f"rank {rank}: backend {dist.get_backend()}")
    dev = torch.device("cuda", torch.cuda.current_device())
    label = f"phase 17 {spec['name']} rank {rank}/{world}"
    trainer, report = scale_fit(dev, spec, make_mesh(model=spec["tp"]),
                                label)
    totals = {}
    for st in report.steps:
        check_launches(st["launches"], f"{label}: a training step", False)
        for k, n in st["launches"].items():
            totals[k] = totals.get(k, 0) + n
    numel = sum(p.numel() for p in trainer.model.parameters()
                if p.requires_grad)
    result = {"rank": rank, "plan": trainer.plan.kind,
              "losses": [st["train/total_loss"] for st in report.steps],
              "step_seconds": [st["step_seconds"] for st in report.steps],
              "launches": totals, "grad_values": numel,
              "allreduce_ms": allreduce_ms(numel, dev)}
    box = [trainer]
    del trainer
    result["state_bytes"] = held_state_bytes(box, spec["tp"])
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def held_state_bytes(box, tp=1):
    """One rank's training state on its card against `parallel.aot`'s
    prediction from shard shapes. The bytes of the live tensors on the
    card (parameters, buffers, the EMA shadow, the optimizer's state: the
    local shards) must equal the prediction's exactly; and how far
    `torch.cuda.memory_allocated` drops as the trainer `box.pop()` lets
    go of its optimizer state, then its EMA, then the rest (parameters,
    buffers, DDP's buckets, which only the prediction counts), the
    caller holding it nowhere else, may exceed the prediction by the
    allocator's rounding alone (`allocator_slack`). -> {"live", "exact",
    "allocated", "predicted", "slack", "ok", "parts": {part: [allocated,
    predicted]}}."""
    import gc

    import torch
    from slotdiffusion_tpu_torch.models import build_model
    from slotdiffusion_tpu_torch.parallel import aot
    from slotdiffusion_tpu_torch.parallel.tp import _local
    trainer = box.pop()
    cfg, data = trainer.params, trainer.data_count
    plan = trainer.plan
    pred = aot.state_bytes(
        build_model(cfg, device="meta"), cfg, data, tp,
        plan is not None and plan.fsdp,
        ddp=plan is not None and plan.kind == "ddp")
    model, core = trainer.model, trainer.optimizer.core
    on_card = [_local(t) for t in [*model.parameters(), *model.buffers(),
                                   *(trainer.ema.shadow.values()
                                     if trainer.ema else ()),
                                   *(v for st in core.state.values()
                                     for v in st.values()
                                     if torch.is_tensor(v) and v.is_cuda)]]
    live = sum(t.numel() * t.element_size() for t in on_card)
    # DDP's buckets: 25 MiB each, and a first one of 1 MiB
    buckets = math.ceil(pred["buckets"] / 2 ** 20 / 25) + 1 \
        if pred["buckets"] else 0
    slack = allocator_slack([t.numel() * t.element_size()
                             for t in on_card] + [2 ** 21] * buckets)
    del model, on_card

    def freed(let_go):
        gc.collect()
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        let_go()
        gc.collect()
        torch.cuda.synchronize()
        return [before - torch.cuda.memory_allocated()]

    parts = {"opt": freed(core.state.clear) + [pred["opt"]]}
    del core
    parts["ema"] = freed(lambda: setattr(trainer, "ema", None)) + \
        [pred["ema"]]
    rest = [trainer]
    del trainer, plan
    parts["params and buckets"] = freed(rest.clear) + \
        [pred["params"] + pred["buckets"]]
    allocated, predicted = (sum(p[i] for p in parts.values())
                            for i in range(2))
    exact = live == pred["params"] + pred["ema"] + pred["opt"]
    return {"live": live, "exact": exact, "allocated": allocated,
            "predicted": predicted, "slack": slack, "parts": parts,
            "ok": exact and 0 <= allocated - predicted <= slack}


def state_bytes_line(held):
    """`held_state_bytes`'s reading, for the log."""
    return (f"its state on the card {held['live']} B of live tensors, "
            f"{held['allocated']} B allocated (DDP's buckets too), "
            f"parallel.aot's prediction {held['predicted']} B (its "
            f"parameters, EMA and optimizer state against the live tensors: "
            f"{'equal' if held['exact'] else 'DIFFER'}; allocator slack "
            f"{held['slack']} B; allocated, predicted by part " +
            ", ".join(
                f"{k} {v}" for k, v in held["parts"].items()) +
            f") {'ok' if held['ok'] else 'FAIL'}")


def allocator_slack(sizes):
    """The most PyTorch's caching allocator may hand out beyond tensors of
    `sizes` bytes: each rounded up to a multiple of 512 bytes, and a
    block over 1 MiB given whole where the rest of its free block would
    be 1 MiB or less (`kSmallSize`: the allocator splits large blocks
    only above it)."""
    return sum(512 + (2 ** 20 if n > 2 ** 20 else 0) for n in sizes)


def first_step_noise(trainer):
    """Make `trainer`'s first adafactor update record, for each parameter
    index, the elements whose gradient is within rounding noise of zero:
    at most ZERO_NOISE of its tensor's largest. -> the dict it fills."""
    from slotdiffusion_tpu_torch.training.optim import Adafactor
    core, masks = trainer.optimizer.core, {}
    step = core.step

    def first():
        if isinstance(core, Adafactor):
            params = [p for g in core.param_groups for p in g["params"]]
            for i, p in enumerate(params):
                if p.grad is not None:
                    g = p.grad.abs()
                    masks[i] = (g <= ZERO_NOISE * g.max()).cpu()
        core.step = step
        return step()

    core.step = first
    return masks


def state_distance(saved, live, skip=(), names=None, noise=None):
    """How far two trainer states are apart, by kind: the parameters, the
    EMA shadow and each of the optimizer's per-parameter moments. For
    each kind, the largest |saved - live| of its tensors over the largest
    |live| of them: a gradient that is zero but for rounding (a bias
    before a GroupNorm) gives Adam's moments of that tensor no scale of
    their own. The rows `skip` names (ZERO_GRADIENT's form) are left out
    of both (`names`: the parameter of each optimizer index), and so are
    the elements `noise` ({parameter index: mask}) marks in the kinds of
    NOISE_KINDS. -> {kind: (that share, the tensor with the largest
    difference)}."""
    import re

    import torch

    def kept(name, a, b):
        for rx, start, end in skip:
            if name is not None and re.search(rx, name) and a.dim():
                n = a.shape[0]
                a, b = a.clone(), b.clone()
                a[round(start * n):round(end * n)] = 0
                b[round(start * n):round(end * n)] = 0
        return a, b

    kinds = {"parameters": [(k, *kept(k, v, live["model"][k]))
                            for k, v in saved["model"].items()]}
    if saved["ema"] is not None:
        kinds["EMA"] = [(k, *kept(k, v, live["ema"]["shadow"][k]))
                        for k, v in saved["ema"]["shadow"].items()]
    adam = live["optimizer"]["core"]["state"]
    for i, st in saved["optimizer"]["core"]["state"].items():
        for n, v in st.items():
            if torch.is_tensor(v) and v.dim():
                a, b = kept(names and names[i], v, adam[i][n])
                if n in NOISE_KINDS and noise and i in noise:
                    mask = noise[i].to(b.device)
                    a = a.masked_fill(mask.to(a.device), 0)
                    b = b.masked_fill(mask, 0)
                kinds.setdefault(n, []).append((i, a, b))
    out = {}
    for kind, pairs in kinds.items():
        diff, scale = (0.0, None), 0.0
        for name, a, b in pairs:
            b = b.to(torch.float64)
            d = (a.to(b.device, torch.float64) - b).abs().max().item()
            diff = max(diff, (d, name), key=lambda x: x[0])
            scale = max(scale, b.abs().max().item())
        out[kind] = (diff[0] / max(scale, 1e-30), diff[1])
    return out


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def scale_out(smi, dev, phase="phase 17"):
    """Phase 17. -> {path: {kernel: launches}}."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from slotdiffusion_tpu_torch import configs, ops, serving
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.training.checkpoint import load_checkpoint

    t_phase = time.time()
    count = torch.cuda.device_count()
    tmp = tempfile.mkdtemp()
    paths = {}
    try:
        # the CPU export runs in its own process while the card trains
        export = subprocess.Popen(
            [sys.executable, "-c", CROSS_EXPORT,
             os.path.dirname(os.path.abspath(__file__)), tmp],
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            ref_trainer, ref = scale_fit(dev, {"clips": SCALE_CLIPS}, None,
                                         f"{phase} one process")
            ref_losses = [st["train/total_loss"] for st in ref.steps]
            paths["scale_out_reference"] = {
                k: sum(st["launches"][k] for st in ref.steps)
                for k in launch_counts()}
            runs = [dict(name="ddp", backend="nccl", world=count, tp=1,
                         clips=SCALE_CLIPS)]
            if count >= 2:
                runs += [dict(name="tp", backend="nccl", world=count, tp=2,
                              clips=SCALE_CLIPS),
                         dict(name="fsdp", backend="nccl", world=count,
                              tp=1, fsdp=True, clips=SCALE_CLIPS)]
            else:
                runs.append(dict(name="ddp-gloo", backend="gloo",
                                 world=GLOO_RANKS, tp=1, clips=SCALE_CLIPS))
            for run in runs:
                run["ckp"] = os.path.join(tmp, run["name"])
            log(f"{phase}: {count} card(s); runs " + ", ".join(
                f"{r['name']} ({r['world']} ranks over {r['backend']}, TP "
                f"{r['tp']}{', FSDP' if r.get('fsdp') else ''}, "
                f"{r['clips']} clips a global step)" for r in runs))
            failed = []
            for run in runs:
                run["out"] = os.path.join(tmp, run["name"] + "_out")
                os.makedirs(run["out"])
                t = time.time()
                mp.start_processes(scale_rank, args=(
                    run["world"], free_port(), run), nprocs=run["world"],
                    start_method="spawn")
                wall = time.time() - t
                ranks = []
                for r in range(run["world"]):
                    with open(os.path.join(run["out"],
                                           f"rank{r}.json")) as f:
                        ranks.append(json.load(f))
                    paths[f"scale_out_{run['name']}_rank{r}"] = \
                        ranks[-1]["launches"]
                rel = max(abs(a - b) / abs(b) for a, b in zip(
                    ranks[0]["losses"], ref_losses))
                ok = rel <= SCALE_LOSS_RTOL and all(
                    rk["losses"] == ranks[0]["losses"] for rk in ranks)
                if not ok:
                    failed.append(run["name"])
                for rk in ranks:
                    held = rk["state_bytes"]
                    log(f"{phase}: {run['name']} rank {rk['rank']}: "
                        + state_bytes_line(held))
                    if not held["ok"]:
                        failed.append(f"{run['name']} state bytes")
                    step = statistics.median(rk["step_seconds"])
                    log(f"{phase}: {run['name']} rank {rk['rank']} "
                        f"({rk['plan']}): steps " + " ".join(
                            f"{x:.3f}" for x in rk["step_seconds"]) +
                        f" s (host clock); one all-reduce of the step's "
                        f"{rk['grad_values'] / 1e6:.1f}M gradient values "
                        f"timed alone {rk['allreduce_ms']:.2f} ms = "
                        f"{rk['allreduce_ms'] / 1e3 / step:.3f} of the "
                        f"median step; launches {rk['launches']} [{smi}]")
                log(f"{phase}: {run['name']}: {run['world']} ranks over "
                    f"{run['backend']} in {wall:.1f}s wall; losses " +
                    " ".join(f"{x:.6f}" for x in ranks[0]["losses"]) +
                    " vs one process " +
                    " ".join(f"{x:.6f}" for x in ref_losses) +
                    f": max rel {rel:.2e} (tol {SCALE_LOSS_RTOL:.0e}) "
                    f"{'ok' if ok else 'FAIL'}")
            # what each run trained (rank 0's ckpt_last) against what the
            # one process trained
            for run in runs:
                ckpt = os.path.join(run["ckp"], "ckpt_last.pt")
                saved = load_checkpoint(ckpt)
                far = state_distance(saved, ref_trainer.state_dict())
                ok = max(d for d, _ in far.values()) <= SCALE_STATE_TOL \
                    and saved["step"] == ref_trainer.step == SCALE_STEPS
                log(f"{phase}: {run['name']}: rank 0's ckpt_last "
                    f"({os.path.getsize(ckpt) / 2 ** 30:.2f} GiB) against "
                    f"the one process's state, each kind's largest "
                    f"difference over its largest value: " + ", ".join(
                        f"{k} {d:.2e} ({n})" for k, (d, n) in far.items()) +
                    f" (tol {SCALE_STATE_TOL:.0e}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    failed.append(f"{run['name']} state")
            # rank 0's DDP checkpoint loaded into the one-process trainer
            ckpt = os.path.join(runs[0]["ckp"], "ckpt_last.pt")
            ref_trainer.load_checkpoint(ckpt)
            saved, live = load_checkpoint(ckpt), ref_trainer.state_dict()
            same = all(d == 0 for d, _ in state_distance(
                saved, live).values()) and \
                live["step"] == saved["step"]
            log(f"{phase}: that ckpt_last loaded into the one process and "
                f"read back bit for bit {'ok' if same else 'FAIL'}")
            if not same:
                failed.append("checkpoint")
            del ref_trainer, saved, live
            gc.collect()
            torch.cuda.empty_cache()
        finally:
            out, _ = export.communicate(timeout=600)
        if export.returncode:
            raise SystemExit(f"{phase}: the cross-device export failed:\n"
                             f"{out[-4000:]}")
        cpu_secs = json.loads(next(
            line for line in out.splitlines()
            if line.startswith("CROSS_EXPORT "))[len("CROSS_EXPORT "):])

        # the same surfaces exported on the card, then both loaded there
        cfg = configs.SAViLDMMoviE128()
        model = build_model(cfg, device=dev)
        init_random_(model, torch.Generator().manual_seed(0))
        card_secs, load_secs, answers = {}, {}, {}
        video, x_t, t_model = serving_inputs(cfg, dev)
        for what in ("encode", "sample"):
            fn, example = serving.build_serving_fn(
                model, what, serving.data_shape(cfg, 2), graphed=False)
            t = time.time()
            serving.save_artifact(os.path.join(tmp, what + "_card.pt2"), fn,
                                  example)
            card_secs[what] = time.time() - t
        del model
        gc.collect()
        torch.cuda.empty_cache()
        ops.reset_launch_counts()
        for where in ("cpu", "card"):
            calls = {}
            for what in ("encode", "sample"):
                t = time.time()
                calls[what], header = serving.load_artifact(
                    os.path.join(tmp, f"{what}_{where}.pt2"), "cuda")
                load_secs[f"{what}_{where}"] = time.time() - t
            slots, masks = calls["encode"](video)
            # `denoise`: the UNet program the `sample` artifact chains,
            # called on its own
            with torch.inference_mode():
                denoised = calls["sample"].module.denoise(
                    x_t, t_model, slots.reshape(-1, *slots.shape[-2:]))
            answers[where] = (slots, masks, denoised,
                              calls["sample"](0, slots))
        torch.cuda.synchronize()
        paths["cross_export"] = launch_counts()
        check_launches(paths["cross_export"], f"{phase}: the artifacts",
                       False)
        same = [torch.equal(a, b) for a, b in zip(answers["cpu"],
                                                  answers["card"])]
        log(f"{phase}: artifacts exported for cuda with no card visible "
            "(export s " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in cpu_secs.items()) +
            ") and on the card (" + ", ".join(
                f"{k} {v:.1f}" for k, v in card_secs.items()) +
            "); load s " + ", ".join(f"{k} {v:.1f}"
                                     for k, v in load_secs.items()) +
            f"; slots, masks, denoise, sample bit-identical {same} "
            f"[{smi}]")
        if not all(same):
            failed.append("cross-device export")
        if failed:
            raise SystemExit(f"{phase}: {failed}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"{phase}: took {time.time() - t_phase:.1f}s")
    return paths


# phase 18: per-card memory under each plan, and the optimizers the plans
# took last (see the module docstring)
# the cards whose local batches the phase steps at (the flagship's 32
# clips over 8 cards: 4 a data rank, 8 under TP 2)
SIZING_CARDS = 8
# the optimizer each sharded plan's gloo run steps with
SIZING_RUNS = (("tp", 2, False, "adam_fused"), ("fsdp", 1, True,
                                                 "adafactor"))
SIZING_STEPS = 2  # the first makes the optimizer's state; the peak is the
# second's
# left out where a sharded run's state is held against one process's:
# the rows of a tensor whose gradient is zero in exact arithmetic, as
# (a regex on its name, the share of its rows where they start and end).
# A bias that shifts every logit a softmax normalises alike cancels in
# it: slot attention's q bias (the softmax over the slots), the k third
# of each self-attention's packed in-projection bias (the softmax over
# the keys). Their updates follow rounding noise, and adafactor's
# momentum, an update over its own root mean square, carries that noise
# at full size (measured: 3.6e-2 of the momentum's largest value at
# either, every other tensor's within SCALE_STATE_TOL)
ZERO_GRADIENT = ((r"slot_attention\.project_q\.0\.bias$", 0.0, 1.0),
                 (r"self_attn\.in_proj_bias$", 1 / 3, 2 / 3))
# adafactor's first update of an unfactored view is the sign of each
# element's gradient (its second moment is that gradient squared), and a
# factored view's is the gradient over its row's and column's root mean
# square, so of a row whose gradients are all noise it is full size as
# well: an element whose gradient is within rounding noise of zero takes
# either sign, and its momentum keeps it. In the kinds of NOISE_KINDS the
# elements whose first gradient in the one process is at most ZERO_NOISE
# of their tensor's largest are left out (`first_step_noise`); in a
# row that is not noise such an element's update is as small as its
# gradient, so leaving it out hides nothing. Measured with the mask on
# the unfactored views only: 0.311 of the momentum's largest value at
# `savi.encoder.encoder.layer3.1.conv1.weight`, a factored conv
NOISE_KINDS = ("m",)
ZERO_NOISE = 1e-4
# a kind the optimizer stores in bf16 (adam_bf16's first moment,
# adafactor's momentum) is rounded after every update, and a sum in
# another order can land the f32 value it rounds on the other side of a
# rounding boundary: such a kind is held to one rounding step of its
# largest value (2^-7 of it; measured 2.58e-3 and 7.36e-3 with the
# mask above), every f32 kind to SCALE_STATE_TOL
BF16_STATE_TOL = 2.0 ** -7
BF16_KINDS = ("m", "mu")
LAUNCHES_PER_STEP = {"gn_silu": GN_PER_UNET, "attention": ATTN_PER_UNET,
                     "slot_attention": 6}


def sizing_trainer(dev, clips, mesh=None, optimizer="adam", fsdp=False):
    """The flagship (seed 0) in a trainer at `clips` global clips a step
    (`mesh`: across processes) -> (trainer, its first global batch's
    block on the card)."""
    import torch
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.data.loader import DataModule
    from slotdiffusion_tpu_torch.data.synthetic import synthetic_video_splits
    from slotdiffusion_tpu_torch.methods.build import build_method
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.parallel import data_coords
    cfg = configs.SAViLDMMoviE128().copy(
        train_batch_size=clips, optimizer=optimizer, fsdp=fsdp,
        use_viz=False, async_ckpt=False)
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    train, _ = synthetic_video_splits(cfg, clips, 0)
    index, count = data_coords(mesh)
    data = DataModule(train, None, clips, seed=0, process_index=index,
                      process_count=count)
    trainer = build_method(model, data, cfg, mesh=mesh)
    batch = next(iter(data.train_loader(0)))
    return trainer, {k: v.to(dev) if hasattr(v, "to") else v
                     for k, v in batch.items()}


def sizing_steps(trainer, batch, what):
    """SIZING_STEPS steps of `trainer` on `batch` through the kernels
    (LAUNCHES_PER_STEP each, exactly) -> (the activation peak of the last
    step: `parallel.aot.step_peak`, its launches, the steps' seconds)."""
    import torch
    from slotdiffusion_tpu_torch import ops
    from slotdiffusion_tpu_torch.parallel import aot
    ops.reset_launch_counts()
    t = time.time()
    peak = aot.step_peak(trainer, batch)
    seconds = time.time() - t
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {k: n * SIZING_STEPS for k, n in LAUNCHES_PER_STEP.items()}
    if {k: counts[k] for k in want} != want:
        raise SystemExit(f"{what}: launches {counts}, want {want}")
    return peak, counts, seconds


def sizing_rank(rank, world, port, spec):
    """One gloo rank of phase 18 on the one card (spawned): the flagship
    laid out by the plan, SIZING_STEPS steps (`sizing_steps`) with the
    plan's optimizer, its whole trained state; then rank 0 trains one
    process the same steps on the same global batch and holds the state
    against it (`state_distance`); every rank's state bytes on the card
    against `parallel.aot` (`held_state_bytes`). Writes JSON."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from slotdiffusion_tpu_torch.training.trainer import _to_host
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    torch.cuda.set_device(0)
    from slotdiffusion_tpu_torch.parallel import (
        make_mesh, maybe_initialize_distributed)
    if not maybe_initialize_distributed(cpu=True, verbose=False):
        raise SystemExit(f"rank {rank}: no multi-process launch detected")
    dev = torch.device("cuda", 0)
    label = f"phase 18 {spec['name']} rank {rank}/{world}"
    mesh = make_mesh(model=spec["tp"], device="cuda")
    trainer, batch = sizing_trainer(dev, spec["clips"], mesh,
                                    spec["optimizer"], spec["fsdp"])
    peak, counts, seconds = sizing_steps(trainer, batch, label)
    # a copy on the host: the whole state's replicated tensors are the
    # trainer's own, which `held_state_bytes` must see let go
    whole = _to_host(trainer.state_dict())
    if rank:
        whole = None
    box = [trainer]
    del trainer
    held = held_state_bytes(box, spec["tp"])
    torch.cuda.empty_cache()
    result = {"rank": rank, "peak": peak, "launches": counts,
              "seconds": seconds, "state_bytes": held}
    if rank == 0:
        one, one_batch = sizing_trainer(dev, spec["clips"],
                                        optimizer=spec["optimizer"])
        noise = first_step_noise(one)
        for _ in range(SIZING_STEPS):
            one.train_step(one_batch)
        result["distance"] = state_distance(
            whole, one.state_dict(), ZERO_GRADIENT,
            one.optimizer.core_names, noise)
        result["noise"] = [sum(int(m.sum()) for m in noise.values()),
                           sum(m.numel() for m in noise.values())]
        del one, whole
    with open(os.path.join(spec["out"], f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


def sizing(smi, dev, phase="phase 18"):
    """Phase 18. -> {path: {kernel: launches}}."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.multiprocessing as mp
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.models import build_model
    from slotdiffusion_tpu_torch.parallel import aot

    t_phase = time.time()
    cfg = configs.SAViLDMMoviE128()
    local = {"dp": cfg.train_batch_size // SIZING_CARDS,
             "tp": cfg.train_batch_size // (SIZING_CARDS // 2),
             "fsdp": cfg.train_batch_size // SIZING_CARDS}
    paths, peaks, failed = {}, {}, []
    tmp = tempfile.mkdtemp()
    runs, procs = [], []
    try:
        # TP 2 and FSDP 2: gloo ranks on the one card, both runs side by
        # side, started first: they build while this process measures DP
        for name, tp, fsdp, optimizer in SIZING_RUNS:
            out = os.path.join(tmp, name)
            os.makedirs(out)
            # the TP run's global batch is its data rank's, FSDP's two
            # data ranks' at the local batch each
            spec = dict(name=name, tp=tp, fsdp=fsdp, optimizer=optimizer,
                        out=out, clips=local[name] * (2 if fsdp else 1))
            runs.append(spec)
            procs.append(mp.start_processes(
                sizing_rank, args=(2, free_port(), spec), nprocs=2,
                start_method="spawn", join=False))
        # DP: a data rank's step is one process's at the local batch
        trainer, batch = sizing_trainer(dev, local["dp"])
        peaks["dp"], paths["sizing_dp"], secs = sizing_steps(
            trainer, batch, f"{phase} dp")
        log(f"{phase}: dp{SIZING_CARDS} at {local['dp']} clips a card: "
            f"{SIZING_STEPS} steps {secs:.2f}s (host clock), activation "
            f"peak {peaks['dp'] / 2 ** 30:.3f} GiB, launches "
            f"{paths['sizing_dp']}")
        del trainer, batch
        gc.collect()
        torch.cuda.empty_cache()
        for ctx in procs:
            while not ctx.join():
                pass
        for spec in runs:
            name = spec["name"]
            ranks = []
            for r in range(2):
                with open(os.path.join(spec["out"], f"rank{r}.json")) as f:
                    ranks.append(json.load(f))
                paths[f"sizing_{name}_rank{r}"] = ranks[-1]["launches"]
            peaks[name] = max(rk["peak"] for rk in ranks)
            far = ranks[0]["distance"]
            ok = all(d <= (BF16_STATE_TOL if k in BF16_KINDS else
                           SCALE_STATE_TOL) for k, (d, _) in far.items())
            if not ok:
                failed.append(f"{name} state")
            for rk in ranks:
                held = rk["state_bytes"]
                if not held["ok"]:
                    failed.append(f"{name} rank {rk['rank']} state bytes")
                log(f"{phase}: {name} ({spec['optimizer']}, 2 gloo ranks on "
                    f"the card, {spec['clips']} clips a global step) rank "
                    f"{rk['rank']}: {SIZING_STEPS} steps {rk['seconds']:.2f}s "
                    f"(host clock), activation peak "
                    f"{rk['peak'] / 2 ** 30:.3f} GiB, "
                    f"{state_bytes_line(held)}, launches "
                    f"{rk['launches']}")
            log(f"{phase}: {name}: the trained state against one process's "
                "on the same global batch, each kind's largest difference "
                "over its largest value: " + ", ".join(
                    f"{k} {d:.2e} ({n})" for k, (d, n) in far.items()) +
                f" (tol {SCALE_STATE_TOL:.0e}, bf16 kinds "
                f"{BF16_STATE_TOL:.2e}; left out: the rows ZERO_GRADIENT "
                f"names, and {ranks[0]['noise'][0]} of "
                f"{ranks[0]['noise'][1]} elements of {NOISE_KINDS} whose "
                f"first gradient is noise) {'ok' if ok else 'FAIL'}")
    finally:
        for ctx in procs:  # after a failure here, no rank outlives it
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
        shutil.rmtree(tmp, ignore_errors=True)
    # the sizing table of SIZING_CARDS cards, with the peaks measured here
    meta = build_model(cfg, device="meta")
    hbm = aot.capacity(dev)
    rows = [aot.size_plan(cfg, meta, SIZING_CARDS, tp, fsdp,
                          activation_peak=peaks[name], hbm=hbm)
            for name, tp, fsdp in (("dp", 1, False), ("tp", 2, False),
                                   ("fsdp", 1, True))]
    for row in rows:
        log(f"{phase}: sizing {json.dumps(row)}")
    log(f"{phase}: sizing table ({smi}; FSDP's activation peak measured "
        "at 2 data ranks)\n" + aot.format_table(rows))
    if failed:
        raise SystemExit(f"{phase}: {failed}")
    log(f"{phase}: took {time.time() - t_phase:.1f}s")
    return paths


# phase 19: the data layer from files. The committed tree and what the
# JAX readers return for it (scripts/make_torch_data_fixture.py)
DATA_FIXTURE = os.path.join("tests", "data", "torch_files")
DATA_CLIPS = 8            # the fixture's flagship batch (its 38 train clips)
DATA_STEPS = 2            # file-backed training steps
DATA_RATE_BATCHES = 16    # batches the input rate is taken over
DATA_MAX_WORKERS = 8


def data_probe():
    """What the machine offers the decode path: the C++ compiler, the
    image libraries' headers and shared objects, whether PIL imports (in
    a child process: this one must not), the CPU count."""
    import tempfile

    def run(cmd, **kw):
        return subprocess.run(cmd, capture_output=True, text=True,
                              timeout=60, **kw)
    out = {"g++": (run(["g++", "--version"]).stdout.splitlines() or
                   ["not found"])[0]}
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "main.cpp")
        for header in ("jpeglib.h", "png.h", "zlib.h"):
            with open(src, "w") as f:
                f.write(f"#include <cstdio>\n#include <{header}>\n"
                        "int main() { return 0; }\n")
            out[header] = run(["g++", "-fsyntax-only", src]).returncode == 0
        with open(src, "w") as f:
            f.write("int main() { return 0; }\n")
        for lib in ("jpeg", "png", "z"):
            out[f"-l{lib}"] = run(["g++", src, "-o", os.path.join(tmp, "a"),
                                   f"-l{lib}"]).returncode == 0
    pil = run([sys.executable, "-c", "import PIL; print(PIL.__version__)"])
    out["PIL"] = pil.stdout.strip() if pil.returncode == 0 else "absent"
    out["cpu_count"] = os.cpu_count()
    return out


@contextlib.contextmanager
def no_pil():
    """`import PIL` (and every PIL module) raises ImportError inside."""
    saved = {k: v for k, v in sys.modules.items()
             if k == "PIL" or k.startswith("PIL.")}
    for k in saved:
        sys.modules[k] = None
    sys.modules["PIL"] = None
    try:
        yield sorted(k for k in saved if saved[k] is not None)
    finally:
        for k in [k for k in sys.modules if k == "PIL" or
                  k.startswith("PIL.")]:
            del sys.modules[k]
        sys.modules.update({k: v for k, v in saved.items()
                            if v is not None})


def input_rate(dataset, workers, bs=DATA_CLIPS):
    """Clips a second the port's loader gives from `dataset` (random index
    batches of `bs` through `make_loader`; `workers` spawned processes,
    each prefetching 2 batches): (seconds until each worker has delivered
    a batch, its start included; clips a second over the next
    DATA_RATE_BATCHES batches, or 7 a worker, whichever is more)."""
    import numpy as np
    from slotdiffusion_tpu_torch.data.loader import make_loader
    warm = max(1, workers)
    batches = warm + max(DATA_RATE_BATCHES, 7 * workers)
    order = np.random.RandomState(0).randint(0, len(dataset), batches * bs)
    loader = make_loader(dataset, order.reshape(batches, bs).tolist(),
                         num_workers=workers)
    t0 = time.time()
    it = iter(loader)
    for _ in range(warm):
        first = next(it)
    t_warm = time.time() - t0
    t1 = time.time()
    n = 0
    for batch in it:
        n += batch["img"].shape[0]
    rate = n / (time.time() - t1)
    if tuple(first["img"].shape[1:]) != (6, 128, 128, 3):
        raise SystemExit(f"the loader gave {tuple(first['img'].shape)}")
    del it, loader
    return t_warm, rate


def data_layer(smi, dev, gen, step_seconds=None, phase="phase 19"):
    """Phase 19: every reader of the port decodes its files with the port's
    own native library (no PIL: importing it raises inside the phase), each
    held bit for bit against what the JAX readers return for the committed
    tree; the flagship's input rate from files at 0 and N spawned workers
    beside what phase 5's step consumes; DATA_STEPS training steps of the
    flagship from the tree through `Trainer`, then `Trainer.validate` on
    the tree's validation clips with FG-ARI and mIoU from the file masks.
    -> {path: {kernel: launches}}."""
    import gc

    import torch
    from slotdiffusion_tpu_torch import configs
    from slotdiffusion_tpu_torch.data import (build_datamodule,
                                              build_dataset, fastio)
    from slotdiffusion_tpu_torch.data import reference_files as rf
    from slotdiffusion_tpu_torch.models import build_model, init_random_

    t_phase = time.time()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        DATA_FIXTURE)
    probe = data_probe()
    log(f"{phase}: probe: {probe['g++']}; headers " + ", ".join(
        f"{h} {'yes' if probe[h] else 'no'}" for h in
        ("jpeglib.h", "png.h", "zlib.h")) + "; links " + ", ".join(
        f"{k} {'yes' if probe[k] else 'no'}" for k in
        ("-ljpeg", "-lpng", "-lz")) + f"; PIL in this Python: "
        f"{probe['PIL']} (the port does not import it); os.cpu_count() "
        f"{probe['cpu_count']} [{smi}]")
    t = time.time()
    lib = fastio.lib()  # NativeLibraryError if it does not build: no fallback
    log(f"{phase}: g++ built {os.path.relpath(lib._name)} in "
        f"{time.time() - t:.1f}s [{smi}]. Decoders: JPEG the port's "
        "decoder (sequential and progressive, Huffman and arithmetic "
        "scans; libjpeg-turbo's ISLOW IDCT as its SIMD code computes it, "
        "fancy upsampling, fixed-point YCbCr), PNG stdlib zlib + the "
        "library's row unfilter (Adam7 too), gray masks as libpng's "
        "simplified API reads them, resizes and polygons the library's "
        "copy of Pillow's arithmetic, the JPEG frames' fused resize the "
        "JAX native path's")
    recoded = rf.load_cases(root).get("recoded", {})
    log(f"{phase}: the tree's files beyond baseline JPEG and plain PNG: " +
        ", ".join(f"{rel} ({how})" for rel, how in sorted(recoded.items())))
    if len(set(recoded.values())) < 6:
        raise SystemExit(f"{phase}: the tree lacks a recoded format: "
                         f"{sorted(set(recoded.values()))}")
    per_path = {}
    with no_pil() as had:
        if had:
            log(f"{phase}: PIL modules loaded before the phase, blocked "
                f"now: {had}")
        # 2. every reader against the JAX readers' references
        refs = rf.load_references(root)
        failed, n_items, n_arrays, worst = [], 0, 0, 0.0
        for case in rf.load_cases(root)["cases"]:
            t = time.time()
            res = rf.check_case(root, case, refs)
            n_items += res["items"]
            n_arrays += res["arrays"]
            worst = max(worst, res["max_abs_err"])
            failed += res["failures"]
            log(f"{phase}: {case['name']} ({case['reader']}): "
                f"{res['items']} items, {res['arrays']} arrays, max_abs_err "
                f"{res['max_abs_err']:.3g} (tol 0) "
                f"{'ok' if not res['failures'] else 'FAIL'} "
                f"{time.time() - t:.2f}s [{smi}]")
        if failed:
            raise SystemExit(f"{phase}: the readers disagree with the JAX "
                             f"readers' references: {failed[:10]}")
        log(f"{phase}: all {n_items} items ({n_arrays} arrays) equal the "
            f"JAX readers' bit for bit (largest difference {worst:.3g}) "
            f"[{smi}]")

        # 3. the flagship's input rate from files
        cfg = configs.SAViLDMMoviE128().copy(
            data_root=os.path.join(root, "movi"), train_batch_size=DATA_CLIPS,
            val_batch_size=DATA_CLIPS, num_workers=0, print_iter=1,
            save_interval=100.0, save_epoch_end=False)
        train_set, _ = build_dataset(cfg)
        workers = min(DATA_MAX_WORKERS, os.cpu_count() or 1)
        rates = {w: input_rate(train_set, w) for w in (0, workers)}
        need = (f"; phase 5's step consumes "
                f"{32 / statistics.median(step_seconds):.1f} clips/s (32 "
                f"clips in {statistics.median(step_seconds):.3f} s, the "
                "median step)" if step_seconds else "")
        log(f"{phase}: input rate, MOVi train split from files at "
            f"{cfg.resolution[0]}x{cfg.resolution[1]}, "
            f"{cfg.n_sample_frames}-frame clips, batches of {DATA_CLIPS}: " +
            ", ".join(f"{w} workers {r:.1f} clips/s (a batch from each "
                      f"after {f:.2f}s)" for w, (f, r) in rates.items()) +
            f"{need} [{smi}]")

        # 4. train the flagship from the tree, then validate on it
        model = build_model(cfg, device=dev)
        init_random_(model, torch.Generator().manual_seed(0))
        model.dm_decoder.vae.requires_grad_(False)
        data = build_datamodule(cfg)
        log(f"{phase}: the flagship from files: {len(data.train_set)} train "
            f"clips ({len(data)} batches of {DATA_CLIPS}), "
            f"{len(data.val_set)} validation clips with their masks")
        trainer, report, totals, _, _ = fit_checked(
            model, cfg, data, phase, DATA_STEPS, unit="clips", smi=smi)
        per_path["data_training"] = totals
        # `fit` validates where `max_steps` caps it (a batch or more)
        for rec in report.val:
            check_launches(rec["launches"], f"{phase}: fit's validate",
                           False)
            per_path["data_fit_validate"] = rec["launches"]
        del trainer
        gc.collect()
        ecfg = cfg.copy(use_ema=True)
        per_path["data_validate"] = validate_against_plain(
            ecfg, model, data, dev, gen, smi, phase,
            f"the tree's {len(data.val_set)} validation clips (masks from "
            "file)")
    del model, data
    gc.collect()
    torch.cuda.empty_cache()
    log(f"{phase}: {time.time() - t_phase:.1f}s [{smi}]")
    return per_path


def main():
    import gc

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch.nn.functional as F
    from slotdiffusion_tpu_torch import configs, ops
    from slotdiffusion_tpu_torch.models import build_model, init_random_
    from slotdiffusion_tpu_torch.ops import (_cuda, attention_kernel,
                                             fused_norm,
                                             slot_attention_kernel,
                                             winograd_conv)
    from slotdiffusion_tpu_torch.serving import build_serving_fn

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # ---- 1. device --------------------------------------------------------
    mark("1")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    import scipy
    log(f"phase 1: device {kind} x{count}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, scipy {scipy.__version__} (the "
        f"metrics' Hungarian matching and SSIM filter), tf32 off")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    # ---- 2. build ---------------------------------------------------------
    mark("2")
    t = time.time()
    lib_path = _cuda.build(verbose=True)
    _cuda.lib()
    log(f"phase 2: nvcc built {os.path.relpath(lib_path)} in "
        f"{time.time() - t:.1f}s")

    # ---- the flagship model, and the kernel shapes its serving path uses --
    cfg = configs.SAViLDMMoviE128()
    model = build_model(cfg, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in model.parameters())
    log(f"built SAViDiffusion (MOVi-E 128x128), {n_params / 1e6:.1f}M "
        "parameters, random weights (seed 0)")
    gen = torch.Generator(device=dev).manual_seed(1)
    inputs = serving_inputs(cfg, dev)
    video, x_t, t_model = inputs
    shapes = serving_shapes(model, inputs)
    log("shapes per request: " + ", ".join(
        f"{len(calls)} {name}" for name, calls in shapes.items()))

    # ---- 3. kernels vs plain versions ------------------------------------
    mark("3")
    sa_mod = model.savi.slot_attention
    results = check_kernels(shapes, sa_mod, gen, dev, "phase 3")
    failed = []
    # Winograd: no model calls it; the flagship UNet's ResBlock conv shapes
    # (scripts/bench_winograd.py), bf16 as the JAX kernel takes them
    wino_shapes = [(32, 32, 32, 128, 128), (32, 16, 16, 256, 256),
                   (32, 8, 8, 384, 384), (32, 4, 4, 512, 512)]
    wino_inputs, wino_extra = [], dict(transform=0.0, call=0.0,
                                       transform_plain=0.0, call_plain=0.0)
    for (Bw, Hw, Ww, C, Fo) in wino_shapes:
        xw = torch.randn(Bw, Hw, Ww, C, generator=gen, device=dev).to(
            torch.bfloat16)
        ww = torch.randn(3, 3, C, Fo, generator=gen, device=dev) * \
            (9 * C) ** -0.5
        wino_inputs.append((xw, ww))
        label = f"B={Bw} {Hw}x{Ww} C={C} F={Fo}"
        # the weight transform: U^T must equal the plain version's bit for
        # bit (the same f32 operations, then bf16)
        ut = winograd_conv.kernel_weights(ww)
        ut_plain = winograd_conv.kernel_weights_reference(ww)
        same_u = torch.equal(ut, ut_plain)
        if not same_u:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} U")
        (t_ms, t_ev), (tp_ms, _) = (
            timed(lambda: winograd_conv.kernel_weights(ww)),
            timed(lambda: winograd_conv.kernel_weights_reference(ww)))
        t_bound = max(bound_terms(9 * C * Fo * 4 + ut.numel() * 2))
        log(f"phase 3: winograd transform {label}: U equals the plain "
            f"version's {'ok' if same_u else 'FAIL'} | device (event) ms: "
            f"kernel {t_ms:.4f} ({t_ev:.4f}), plain {tp_ms:.4f}, bound "
            f"{t_bound:.4f} (bytes)")
        # the convolution on U, against F.conv2d with its weights already
        # in bf16 (channels-last): like for like
        kern = lambda: winograd_conv.winograd_conv3x3_u(xw, ut, Fo)
        plain = lambda: winograd_conv.winograd_reference_u(xw, ut, Fo)
        xc = xw.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        wc = ww.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = lambda: F.conv2d(xc, wc, padding=1)
        y, ref = kern().float(), plain().float()
        err = (y - ref).abs().max().item()
        f32 = winograd_conv.direct_conv(xw.float(), ww)
        rel32 = ((y - f32).abs().max() / f32.abs().max()).item()
        log(f"phase 3: winograd_conv3x3 {label}: vs the f32 direct conv "
            f"{rel32:.2e} of its scale (tol {WINO_F32_TOL:.0e})")
        if not rel32 <= WINO_F32_TOL:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} vs f32 conv")
        terms = bound_terms(
            2 * (Bw * Hw * Ww * C + 16 * C * Fo + Bw * Hw * Ww * Fo),
            bf16_ops=8.0 * Bw * Hw * Ww * C * Fo)
        record(results, failed, "phase 3", "winograd_conv3x3", 1,
               f"conv on U {label}", err, WINO_TOL * ref.abs().max().item(),
               timed(kern), timed(plain), timed(lib), terms)
        # the whole call (transform + convolution), as a caller without U
        call = lambda: winograd_conv.winograd_conv3x3(xw, ww)
        call_plain = lambda: winograd_conv.winograd_reference(xw, ww)
        c_err = (call().float() - call_plain().float()).abs().max().item()
        (c_ms, c_ev), (cp_ms, _) = timed(call), timed(call_plain)
        c_tol = WINO_TOL * ref.abs().max().item()
        if not c_err <= c_tol:
            failed.append(f"winograd_conv3x3 {Hw}x{Ww} whole call")
        log(f"phase 3: winograd whole call {label}: max_abs_err "
            f"{c_err:.3e} (tol {c_tol:.1e}) "
            f"{'ok' if c_err <= c_tol else 'FAIL'} | device (event) ms: "
            f"kernel {c_ms:.4f} ({c_ev:.4f}), plain {cp_ms:.4f}")
        for key, val in (("transform", t_ms), ("call", c_ms),
                         ("transform_plain", tp_ms), ("call_plain", cp_ms)):
            wino_extra[key] += val
    # ragged edges the serving shapes do not reach: a partial query tile
    # and key tile, a partial k/v tile, more keys than one pass stages,
    # few slots, other widths; (name, shape label, error, tolerance)
    edge = []
    for (Bq, nq, nk, heads) in ((3, 100, 70, 3), (2, 40, 300, 2)):
        q = torch.randn(Bq, nq, 32 * heads, generator=gen, device=dev)
        k = torch.randn(Bq, nk, 32 * heads, generator=gen, device=dev)
        err = (attention_kernel.fused_mha(q, k, k, heads) -
               attention_kernel.mha_reference(q, k, k, heads)
               ).abs().max().item()
        edge.append(("attention", f"Nq={nq} Nk={nk}", err, TOL["attention"]))
    D, M = 64, 128
    pe = {key: torch.randn(shp, generator=gen, device=dev) * 0.1
          for key, shp in sa_weight_shapes(D, M).items()}
    ks = torch.randn(3, 1000, D, generator=gen, device=dev)
    s0 = torch.randn(3, 7, D, generator=gen, device=dev)
    kw = dict(num_iterations=3, eps=1e-6, return_last_attn=True)
    (ko, km) = slot_attention_kernel.sa_iterations(ks, ks, s0, pe, **kw)
    (po, pm) = slot_attention_kernel.sa_iterations_ref(ks, ks, s0, pe, **kw)
    edge.append(("slot_attention", "N=1000 S=7 D=64",
                 max((ko - po).abs().max().item(),
                     (km - pm).abs().max().item()), TOL["slot_attention"]))
    # one item on a cluster of 16 with all 16 slots; N = 1001 (not a
    # multiple of 16 blocks); D = 66 (not a multiple of 8 or 16: 4-byte
    # k/v copies, zero-padded MMA depth); the largest S, D and M
    for (Bs, N, S, D, M) in ((1, 1024, 16, 192, 384), (2, 1001, 15, 192, 384),
                             (2, 77, 5, 66, 100), (3, 300, 16, 256, 1024)):
        pe = {key: torch.randn(shp, generator=gen, device=dev) * (
            shp[0] ** -0.5 if len(shp) == 2 else 0.1)
            for key, shp in sa_weight_shapes(D, M).items()}
        ks, vs = (torch.randn(Bs, N, D, generator=gen, device=dev)
                  for _ in range(2))
        s0 = torch.randn(Bs, S, D, generator=gen, device=dev)
        kw = dict(num_iterations=2, eps=1e-8, return_last_attn=True)
        out = slot_attention_kernel.sa_iterations(ks, vs, s0, pe, **kw)
        ref = slot_attention_kernel.sa_iterations_ref(ks, vs, s0, pe, **kw)
        label = (f"B={Bs} N={N} S={S} D={D} M={M} plan "
                 f"{slot_attention_kernel.launch_plan(Bs, N, S, D, M)}")
        if not same_bits(out, slot_attention_kernel.sa_iterations(
                ks, vs, s0, pe, **kw)):
            failed.append(f"slot_attention edge {label} not deterministic")
        edge.append(("slot_attention", label, max_err(out, ref),
                     TOL["slot_attention"]))
    xg = torch.randn(5, 96, 7, 9, generator=gen, device=dev)
    wg = torch.ones(96, device=dev)
    edge.append(("gn_silu", "(5, 96, 7, 9)", (
        fused_norm.fused_group_norm(xg, wg, wg, 24, 1e-5, "silu") -
        fused_norm.group_norm_reference(xg, wg, wg, 24, 1e-5, "silu")
    ).abs().max().item(), TOL["gn_silu"]))
    # runs of 50 values (not a multiple of 4): the 4-byte path
    xg = torch.randn(2, 6, 5, 5, generator=gen, device=dev)
    wg = 1 + 0.1 * torch.randn(6, generator=gen, device=dev)
    edge.append(("gn_silu", "(2, 6, 5, 5) G=3", (
        fused_norm.fused_group_norm(xg, wg, wg, 3, 1e-5, None) -
        fused_norm.group_norm_reference(xg, wg, wg, 3, 1e-5, None)
    ).abs().max().item(), TOL["gn_silu"]))
    # Winograd: partial tile and channel blocks, odd H or W, C not a
    # multiple of the kernel's 64-channel chunk; C = 70 takes the V pass's
    # two-channel path (C not a multiple of 4)
    for (Bw, Hw, Ww, C, Fo) in ((3, 9, 14, 72, 40), (2, 7, 5, 70, 24)):
        xw = torch.randn(Bw, Hw, Ww, C, generator=gen, device=dev).to(
            torch.bfloat16)
        ww = torch.randn(3, 3, C, Fo, generator=gen, device=dev) * 0.04
        ref = winograd_conv.winograd_reference(xw, ww).float()
        edge.append(("winograd_conv3x3", f"({Bw}, {Hw}, {Ww}, {C}) F={Fo}",
                     (winograd_conv.winograd_conv3x3(xw, ww).float() - ref
                      ).abs().max().item(),
                     WINO_TOL * ref.abs().max().item()))
    host = gn_host_split(dev)
    log("phase 3: GN wrapper host us a call (12x512x4x4): " + ", ".join(
        f"{k} {v:.2f}" for k, v in host.items()))
    for name, label, err, tol in edge:
        ok = err <= tol
        log(f"phase 3: {name} ragged-edge shape {label}: max_abs_err "
            f"{err:.3e} (tol {tol:.1e}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failed.append(f"{name} edge {label}")
    if failed:
        raise SystemExit(f"kernels disagree with their plain versions: "
                         f"{failed}")

    # the Winograd kernel's own path: its public entry point at the four
    # shapes, with the counts set to 0 just before and read just after
    ops.reset_launch_counts()
    for xw, ww in wino_inputs:
        winograd_conv.winograd_conv3x3(xw, ww)
    torch.cuda.synchronize()
    per_path = {"winograd_conv3x3": launch_counts()}
    log(f"phase 3: launches through winograd_conv3x3 "
        f"{per_path['winograd_conv3x3']}")

    # ---- 3b. the autograd.Functions' gradients on the card -------------
    mark("3b")
    cases = model_grad_cases(shapes, sa_mod, gen, dev)
    cases["winograd_conv3x3"] = (winograd_conv.winograd_conv3x3,
                                 winograd_conv.direct_conv, wino_inputs[1])
    check_grads(cases, gen, dev, "phase 3b")

    # ---- 4. the serving path through the kernels -------------------------
    mark("4")
    per_surface, surface_seconds, slots = serve(cfg, model, inputs,
                                                "phase 4")
    per_path["serving"] = {k: sum(c[k] for c in per_surface.values())
                           for k in launch_counts()}
    log(f"phase 4: launches on the serving path {per_path['serving']}")

    # the same model on the CPU runs the plain versions: one denoise frame
    # and one 2-frame encode must agree with the card's kernel path
    cpu = build_model(cfg, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    d_gpu = build_serving_fn(model, "denoise", graphed=False)(
        x_t[:1], t_model[:1], slots[:1, :1]).cpu()
    d_cpu = build_serving_fn(cpu, "denoise")(
        x_t[:1].cpu(), t_model[:1].cpu(), slots[:1, :1].cpu())
    s_gpu, m_gpu = build_serving_fn(model, "encode", graphed=False)(
        video[:1, :2])
    s_cpu, m_cpu = build_serving_fn(cpu, "encode")(video[:1, :2].cpu())
    # f32 through ~100 layers whose sums run in another order on the card:
    # 1e-3 of the output's scale. The encode also rounds k, v, q and the
    # attention weights to bf16 after f32 sums that differ in their last
    # bits, so a few elements land one bf16 ulp (2^-8 relative) apart and
    # a large q_d * k_d term moves a logit by up to ~1e-2 and a mask value
    # by a quarter of that: 1e-2 there
    for name, a, b, tol in (("denoise", d_gpu, d_cpu, 1e-3),
                            ("encode slots", s_gpu.cpu(), s_cpu, 1e-2),
                            ("encode masks", m_gpu.cpu(), m_cpu, 1e-2)):
        rel = ((a - b).abs().max() / b.abs().max()).item()
        log(f"phase 4: {name} card vs CPU plain path: max rel err "
            f"{rel:.2e} (tol {tol:.0e})")
        if not rel <= tol:
            raise SystemExit(f"{name}: the card disagrees with the CPU")
    del cpu

    # ---- 5. the training path --------------------------------------------
    mark("5")
    per_path["training"], train_results, step_seconds = train(
        cfg, model, dev, gen, "phase 5")

    # ---- 6. the evaluation path ------------------------------------------
    mark("6")
    eval_paths, res64 = evaluate(cfg, model, dev, gen, smi, "phase 6")
    per_path.update(eval_paths)

    # ---- 8 (f32). serving from CUDA graphs, artifacts, HTTP -------------
    mark("8 (f32)")
    graph_failed = []
    serve_graphed(cfg, model, inputs, "phase 8 (f32)", per_path,
                  graph_failed)
    del model, sa_mod, cases
    gc.collect()
    torch.cuda.empty_cache()

    # ---- 7. the flagship in bf16: phases 4-6 again ------------------------
    mark("7")
    cfg16 = cfg.copy(use_bf16=True)
    model = build_model(cfg16, device=dev)
    init_random_(model, torch.Generator().manual_seed(0))
    if any(p.dtype != torch.float32 for p in model.parameters()):
        raise SystemExit("the bf16 model's parameters are not all f32")
    log("phase 7: built SAViDiffusion (MOVi-E 128x128) with use_bf16: "
        "bf16 compute, f32 parameters, random weights (seed 0, as phase 4)")
    bf16_serve = check_bf16_kernels(serving_shapes(model, inputs), gen,
                                    dev, "phase 7")
    per_surface16, _, slots = serve(cfg16, model, inputs, "phase 7",
                                    surface_seconds)
    per_path["bf16_serving"] = {k: sum(c[k] for c in per_surface16.values())
                                for k in launch_counts()}
    bf16_vs_plain(model, inputs, slots)
    per_path["bf16_training"], bf16_train, _ = train(
        cfg16, model, dev, gen, "phase 7", step_seconds)
    per_path.update(evaluate(cfg16, model, dev, gen, smi, "phase 7")[0])
    # ---- 8 (bf16) --------------------------------------------------------
    mark("8 (bf16)")
    serve_graphed(cfg16, model, inputs, "phase 8 (bf16)", per_path,
                  graph_failed)
    if graph_failed:
        raise SystemExit(f"graphed serving, artifacts or HTTP failed: "
                         f"{graph_failed}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    for name, r in bf16_serve.items():
        base = results[name.removesuffix("_bf16")]
        log(f"phase 7: {name} per serving request {r['ms']:.4f} ms device "
            f"(f32 entry, phase 3: {base['ms']:.4f} ms), bound "
            f"{max(r['t_bytes'], r['t_ops']):.4f} ms (f32: "
            f"{max(base['t_bytes'], base['t_ops']):.4f}), library "
            f"{r['lib']:.4f} ms (f32: {base['lib']:.4f}); per training "
            f"step's forward {bf16_train[name]['ms']:.4f} ms (f32, phase 5:"
            f" {train_results[name.removesuffix('_bf16')]['ms']:.4f} ms)")

    # ---- 9. stage 1, and the flagship on its checkpoint ----------------
    mark("9")
    per_path.update(stage1(smi, dev, gen))

    # ---- 10. every sampler of the decoder --------------------------------
    mark("10")
    per_path.update(samplers(smi, dev))

    # ---- 11. the image family ---------------------------------------------
    mark("11")
    img_paths, img_sa = images(smi, dev, gen)
    per_path.update(img_paths)

    # ---- 12. the token and reconstruction baselines ----------------------
    mark("12")
    base_paths, base_sa, base_secs = baselines(smi, dev, gen)
    per_path.update(base_paths)

    # ---- 13. COCO and VOC with the frozen DINO ViT ----------------------
    mark("13")
    coco_paths, coco_k, gn_long_res, sdpa = coco_voc(smi, dev, gen)
    per_path.update(coco_paths)

    # ---- 14. the video-prediction and VQA stage -------------------------
    mark("14")
    per_path.update(vp_vqa(smi, dev, gen))

    # ---- 15. the trainer's optimizers and settings, the reference .pth --
    mark("15")
    per_path.update(settings(smi, dev))

    # ---- 16. evaluation: comp gen, FID/FVD, test_recon, the viz ---------
    mark("16")
    per_path.update(evaluation(smi, dev, gen))

    # ---- 17. scale-out across processes, cross-device export ------------
    mark("17")
    per_path.update(scale_out(smi, dev))

    # ---- 18. per-card memory under each plan, every optimizer sharded ---
    mark("18")
    per_path.update(sizing(smi, dev))

    # ---- 19. the data layer from files ----------------------------------
    mark("19")
    per_path.update(data_layer(smi, dev, gen, step_seconds))

    # ---- 20. report -----------------------------------------------------
    mark("20")
    mods = {m.KERNEL_NAME: m for m in ops.KERNEL_MODULES}
    # the bf16 GN entry's launches by route on each path that launched it,
    # which add up to its launches there
    routes = {s: {r: c.get(f"gn_silu_bf16.{r}", 0) for r in fused_norm.ROUTES}
              for s, c in per_path.items() if c.get("gn_silu_bf16")}
    if any(sum(n.values()) != per_path[s]["gn_silu_bf16"]
           for s, n in routes.items()):
        raise SystemExit(f"the bf16 GN launches by route do not add up to "
                         f"its launches on each path: {routes}")
    log("phase 20: bf16 GN launches by route on each path: " + ", ".join(
        f"{s} {nonzero(n)}" for s, n in routes.items()))
    kernels = []
    for name, r in results.items():
        m = mods[name]
        extra = {} if name != "winograd_conv3x3" else {
            # `ms` is the convolution on U; these the transform and the
            # whole call, summed over the same four shapes
            "transform_ms": wino_extra["transform"],
            "transform_plain_ms": wino_extra["transform_plain"],
            "call_ms": wino_extra["call"],
            "call_plain_ms": wino_extra["call_plain"]}
        kernels.append({
            "name": name, "route": m.ROUTE, "source": m.SOURCE,
            "replaces": f"{ops.REFERENCE_PACKAGE}/{m.REPLACES}",
            "launches": sum(c[name] for c in per_path.values()),
            "max_abs_err": max(r["err"], train_results.get(
                name, {"err": 0.0})["err"], coco_k.get(
                    name, {"err": 0.0})["err"], *[
                    res[name]["err"] for res in base_sa.values()
                    if name in res]),
            "ms": r["ms"], "event_ms": r["event"],
            "plain_ms": r["plain"],
            "bound_ms": max(r["t_bytes"], r["t_ops"]),
            "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                         else "operations"),
            "library_ms": r["lib"] if r["has_lib"] else None,
            "train_ms": train_results[name]["ms"]
            if name in train_results else None,
            "train_plain_ms": train_results[name]["plain"]
            if name in train_results else None,
            "per_path_launches": {s: c[name] for s, c in per_path.items()},
            "per_surface_launches": {s: c[name]
                                     for s, c in per_surface.items()},
            **({} if name not in res64 else {
                # one call at the res64 model's shape (phase 6)
                "res64_ms": res64[name]["ms"],
                "res64_plain_ms": res64[name]["plain"],
                "res64_bound_ms": max(res64[name]["t_bytes"],
                                      res64[name]["t_ops"]),
                "res64_max_abs_err": res64[name]["err"]}),
            **({} if name not in img_sa else {
                # one call per image `encode` (phase 11: B = 8, N = 1024,
                # S = 11, D = 192, M = 384, 3 iterations)
                "img_ms": img_sa[name]["ms"],
                "img_event_ms": img_sa[name]["event"],
                "img_plain_ms": img_sa[name]["plain"],
                "img_bound_ms": max(img_sa[name]["t_bytes"],
                                    img_sa[name]["t_ops"]),
                "img_bound_by": ("bytes" if img_sa[name]["t_bytes"] >=
                                 img_sa[name]["t_ops"] else "operations"),
                "img_max_abs_err": img_sa[name]["err"],
                "img_launches_per_encode": img_paths["image_encode"][name]}),
            **{f"{fam}_train_{k}": v for fam, res in base_sa.items()
               if name in res for k, v in (
                   # a training step's forward calls (phase 12: SAVi's
                   # no-mask return at B = 32 a frame, N = 1024, S = 15, 2
                   # iterations; STEVE's with masks; SLATE's at B = 64,
                   # S = 11, 3 iterations)
                   ("ms", res[name]["ms"]), ("event_ms", res[name]["event"]),
                   ("plain_ms", res[name]["plain"]),
                   ("bound_ms", max(res[name]["t_bytes"],
                                    res[name]["t_ops"])),
                   ("bound_by", "bytes" if res[name]["t_bytes"] >=
                    res[name]["t_ops"] else "operations"),
                   ("max_abs_err", res[name]["err"]))},
            **({"baseline_seconds": base_secs}
               if name == "slot_attention" else {}),
            **({} if name not in coco_k else {
                # the COCO serving shapes (phase 13: 8 images of 224x224;
                # GN and attention per UNet call at 56x56 latents, slot
                # attention per `encode`: N = 784, S = 7, D = 256)
                "coco_ms": coco_k[name]["ms"],
                "coco_event_ms": coco_k[name]["event"],
                "coco_plain_ms": coco_k[name]["plain"],
                "coco_library_ms": coco_k[name]["lib"]
                if coco_k[name]["has_lib"] else None,
                "coco_bound_ms": max(coco_k[name]["t_bytes"],
                                     coco_k[name]["t_ops"]),
                "coco_bound_by": ("bytes" if coco_k[name]["t_bytes"] >=
                                  coco_k[name]["t_ops"] else "operations"),
                "coco_max_abs_err": coco_k[name]["err"]}),
            **({} if name != "gn_silu" else {
                f"long_run_{k}": v for k, v in gn_long_res.items()}),
            **extra,
        })
    for name, r in bf16_serve.items():
        base = name.removesuffix("_bf16")
        m, tr = mods[base], bf16_train[name]
        kernels.append({
            "name": name, "entry": m.ENTRY[torch.bfloat16], "dtype": "bf16",
            "route": m.ROUTE, "source": m.SOURCE,
            "replaces": f"{ops.REFERENCE_PACKAGE}/{m.REPLACES}",
            "launches": sum(c[name] for c in per_path.values()),
            "max_abs_err": max(r["err"], tr["err"]),
            "ms": r["ms"], "event_ms": r["event"], "plain_ms": r["plain"],
            "bound_ms": max(r["t_bytes"], r["t_ops"]),
            "bound_by": ("bytes" if r["t_bytes"] >= r["t_ops"]
                         else "operations"),
            "library_ms": r["lib"],
            "train_ms": tr["ms"], "train_plain_ms": tr["plain"],
            "train_library_ms": tr["lib"],
            "train_bound_ms": max(tr["t_bytes"], tr["t_ops"]),
            # the f32 entry point at the same shapes (phases 3 and 5)
            "f32_ms": results[base]["ms"],
            "f32_train_ms": train_results[base]["ms"],
            "per_path_launches": {s: c[name] for s, c in per_path.items()},
            # attention at COCO's 784 tokens (phase 13): the kernel, SDPA,
            # the plain version, the bound and the kernel's error
            **({} if name != "attention_bf16" else {
                f"sdpa_bf16_{k}": v for k, v in sdpa.items()}),
            # GN's bf16 launches by route on each path that launched it
            # (phase 13 gives each route a case of its own)
            **({} if name != "gn_silu_bf16" else {
                "launches_by_route": routes}),
        })
    log("phase times (s, in run order): " + ", ".join(
        f"{p} {t:.1f}" for p, t in phase_times()))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
