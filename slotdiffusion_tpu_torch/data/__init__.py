"""Data of the port (the counterpart of the JAX package's data/builders.py
:11-157 for `dataset="movi"`, `"steve_movi"`, `"synthetic_video"`,
`"synthetic"`, `"clevrtex"` and `"celeba"`): `build_dataset` returns the
datasets a config names, `build_datamodule` batches them with
`loader.DataModule`. The other datasets are not ported yet."""


def build_dataset(params, val_only=False):
    """-> the val/test set (`val_only`), or (train set, val set)."""
    name = params.dataset
    if name == "synthetic_video":
        from .synthetic import synthetic_video_splits
        # the JAX builder's sizes and defaults (data/builders.py:29-43)
        train, val = synthetic_video_splits(
            params, getattr(params, "train_samples", 256),
            getattr(params, "val_samples", 32))
        return val if val_only else (train, val)
    if name == "synthetic":
        from .synthetic import synthetic_image_splits
        train, val = synthetic_image_splits(params)
        return val if val_only else (train, val)
    if name == "clevrtex":
        from .clevrtex import build_clevrtex_dataset
        return build_clevrtex_dataset(params, val_only=val_only)
    if name == "celeba":
        from .celeba import build_celeba_dataset
        return build_celeba_dataset(params, val_only=val_only)
    if name in ("movi", "steve_movi"):
        from .movi import build_movi_dataset
        return build_movi_dataset(params, val_only=val_only)
    raise ValueError(f"dataset {name!r} is not ported yet")


def build_datamodule(params):
    """The train and val loaders of the dataset `params` names."""
    from .loader import DataModule
    train, val = build_dataset(params)
    return DataModule(train, val, params.train_batch_size,
                      getattr(params, "val_batch_size", None),
                      seed=params.seed,
                      num_workers=getattr(params, "num_workers", 0))
