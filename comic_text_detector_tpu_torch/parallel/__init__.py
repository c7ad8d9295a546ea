"""Scaling: device meshes, sharded batches, multi-process loading."""

from comic_text_detector_tpu_torch.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate,
    shard_batch,
)
