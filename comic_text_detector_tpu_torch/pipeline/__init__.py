"""End-user pipelines: TextDetector (reference-compatible API) and the
batch stream, BatchTextDetector."""

from comic_text_detector_tpu_torch.pipeline.batch import BatchTextDetector  # noqa: F401
from comic_text_detector_tpu_torch.pipeline.detector import TextDetector  # noqa: F401
