"""Training data: datasets, loaders, augmentations and DB ground-truth maps."""
