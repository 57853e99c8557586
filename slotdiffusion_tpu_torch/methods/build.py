"""Trainer configuration per model (mirrors the JAX package's
methods/build.py:85-131 for SAViDiffusion): the `dm_decoder` LR group at
`dec_lr` and the run's seed."""

from ..training.trainer import Trainer


def build_method(model, datamodule, params, ckp_path=None):
    """-> a `Trainer` for `model` as `params` configures it."""
    if params.model != "SAViDiffusion":
        raise ValueError(f"training {params.model!r} is not ported yet")
    lr_groups = {"dm_decoder": params.dec_lr} \
        if params.dec_lr != params.lr else None
    return Trainer(model, datamodule, params, ckp_path=ckp_path,
                   lr_groups=lr_groups, seed=params.seed)
