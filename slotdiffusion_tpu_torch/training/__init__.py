"""Training of the port: Adam with the cosine-warmup schedule, LR groups,
global-norm clipping and gradient accumulation (`optim`), the LitEma
shadow (`ema`), the port's checkpoint format (`checkpoint`) and the loop
(`trainer`). Mirrors the JAX package's `training/`."""
