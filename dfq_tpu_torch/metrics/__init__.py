from dfq_tpu_torch.metrics.segmentation import SegEvaluator  # noqa: F401
from dfq_tpu_torch.metrics.detection import (  # noqa: F401
    compute_average_precision,
    compute_voc2007_average_precision,
)
