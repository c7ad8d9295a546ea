"""End-user pipelines: TextDetector (reference-compatible API), the
batch stream (BatchTextDetector) and the annotation tools."""

from comic_text_detector_tpu_torch.pipeline.batch import BatchTextDetector  # noqa: F401
from comic_text_detector_tpu_torch.pipeline.detector import TextDetector  # noqa: F401
from comic_text_detector_tpu_torch.pipeline.annotations import model2annotations, traverse_by_dict  # noqa: F401
