"""Model export: the ``torch.export`` deploy program with its parity check,
and the reference's ONNX deploy file."""

from comic_text_detector_tpu_torch.export.onnx import export_onnx  # noqa: F401
from comic_text_detector_tpu_torch.export.program import (  # noqa: F401
    concate_models,
    export_program,
    load_exported,
    parity_check,
)
