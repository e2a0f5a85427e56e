from dfq_tpu_torch.detection.box_utils import (  # noqa: F401
    SSDSpec,
    convert_locations_to_boxes,
    center_form_to_corner_form,
    generate_ssd_priors,
    hard_nms,
    iou_of,
    soft_nms,
)
from dfq_tpu_torch.detection.predictor import Predictor  # noqa: F401
