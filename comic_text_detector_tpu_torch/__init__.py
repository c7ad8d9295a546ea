"""comic_text_detector_tpu_torch — the PyTorch + CUDA port of
``comic_text_detector_tpu`` for NVIDIA Hopper (H100).

The package mirrors the JAX package's module names so each counterpart is
easy to find, and imports nothing from it: what both need is copied.  Plain
tensor work is PyTorch; each Pallas kernel of the ported path is a CUDA
kernel written by hand (``csrc/``), built with ``nvcc`` on first use and
bound with ``ctypes``.

Entry points run on ``device="cuda"`` unless the caller asks for
``device="cpu"``; without a card they raise instead of carrying on on the CPU.
"""

__version__ = "0.1.0"

from comic_text_detector_tpu_torch.constants import (  # noqa: F401
    LANG_LIST,
    LANGCLS2IDX,
    REFINEMASK_ANNOTATION,
    REFINEMASK_INPAINT,
)
