"""End-user pipeline: TextDetector (reference-compatible API)."""

from comic_text_detector_tpu_torch.pipeline.detector import TextDetector  # noqa: F401
