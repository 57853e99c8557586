"""Data of the port (the counterpart of the JAX package's data/builders.py
:11-157, every dataset it names: `dataset="movi"`, `"steve_movi"`,
`"synthetic_video"`, `"synthetic"`, `"synthetic_coco"`, `"clevrtex"`,
`"celeba"`, `"coco"`, `"voc"`, the slot datasets `"synthetic_slots"`,
`"synthetic_video_slots"`, `"synthetic_rollout_slots"`, `"physion_slots*"`,
and the Physion videos `"physion*"`): `build_dataset` returns the
datasets a config names, `collate_fn` the batching they need (COCO's
pads its boxes), `build_datamodule` batches them with
`loader.DataModule`."""

# the datasets whose samples carry variable-length `annos`
COCO_LIKE = ("coco", "synthetic_coco")
# the synthetic slot datasets of the video-prediction stage
SLOT_DATASETS = ("synthetic_slots", "synthetic_video_slots",
                 "synthetic_rollout_slots")


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
    if name == "synthetic_coco":
        from .synthetic import synthetic_coco_splits
        train, val = synthetic_coco_splits(params)
        return val if val_only else (train, val)
    if name == "coco":
        from .coco import build_coco_dataset
        return build_coco_dataset(params, val_only=val_only)
    if name == "voc":
        from .voc import build_voc_dataset
        return build_voc_dataset(params, val_only=val_only)
    if name in SLOT_DATASETS:
        from .synthetic_slots import build_slots_dataset
        return build_slots_dataset(params, val_only=val_only)
    # the upstream names: `physion_training` (the video model),
    # `physion_slots_training` (the dynamics), `physion_slots_label_readout`
    # and `physion_slots_label_test` (the readout); slots before videos
    if name.startswith("physion_slots"):
        from .physion_slots import build_physion_slots_dataset
        return build_physion_slots_dataset(params, val_only=val_only)
    if name == "physion" or name.startswith("physion_"):
        from .physion import build_physion_dataset
        return build_physion_dataset(params, val_only=val_only)
    raise ValueError(f"unknown dataset {name!r}")


def collate_fn(params):
    """The batching of the dataset `params` names: `coco_collate_fn` for
    COCO and synthetic COCO, None (torch's default) for the rest."""
    if params.dataset in COCO_LIKE:
        from .coco import coco_collate_fn
        return coco_collate_fn
    return None


def build_datamodule(params):
    """The train and val loaders of the dataset `params` names."""
    from .loader import DataModule
    train, val = build_dataset(params)
    return DataModule(train, val, params.train_batch_size,
                      getattr(params, "val_batch_size", None),
                      seed=params.seed,
                      num_workers=getattr(params, "num_workers", 0),
                      collate_fn=collate_fn(params))
