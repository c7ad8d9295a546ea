"""Shared constants of the framework.

Numeric thresholds mirror the reference defaults so a user can switch
frameworks without re-tuning (reference: inference.py:120,139,159,
utils/textblock.py:9-10).  Own copy of the JAX package's ``constants.py``.

Frozen copy of the port's ``constants.py`` for the benchmark's plain reference,
which imports nothing of the port.
"""

# Language classes emitted by the text-block detector head.
LANG_LIST = ["eng", "ja", "unknown"]
LANGCLS2IDX = {"eng": 0, "ja": 1, "unknown": 2}

# Forward modes of the train-time composite model (reference basemodel.py:17-19).
TEXTDET_MASK = 0
TEXTDET_DET = 1
TEXTDET_INFERENCE = 2

# refine_mask modes (reference utils/textmask.py:13-14).
REFINEMASK_INPAINT = 0
REFINEMASK_ANNOTATION = 1

# Default detection thresholds (reference inference.py:120,139,159).
DEFAULT_INPUT_SIZE = 1024
DEFAULT_CONF_THRESH = 0.4
DEFAULT_NMS_THRESH = 0.35
DEFAULT_MASK_THRESH = 0.3
DEFAULT_DB_THRESH = 0.3
DEFAULT_BOX_THRESH = 0.6
DEFAULT_UNCLIP_RATIO = 1.5

# Letterbox stride: shapes are padded to multiples of this, bounding the set
# of compiled shapes (reference inference.py:75).
LETTERBOX_STRIDE = 64

# Device NMS / DB-decode fixed capacities (fixed shapes, as in the JAX package).
MAX_DET = 300  # reference utils/yolov5_utils.py:125 max_det
MAX_NMS_CANDIDATES = 512
MAX_DB_COMPONENTS = 256  # max text-line components per page
