"""Data layer: datasets, samplers, sharding, transforms, loaders, readers."""

from unite_torch.data.collate_mixup import FastCollateMixup  # noqa: F401
