from dfq_tpu_torch.utils.profiling import layer_costs, roofline_report, trace  # noqa: F401
from dfq_tpu_torch.utils.visualize import visualize_per_layer  # noqa: F401
