from dfq_tpu_torch.calib.distill import DistillConfig, distill_data  # noqa: F401
from dfq_tpu_torch.calib.calibrate import calibrate_ranges, estimate_stats  # noqa: F401
from dfq_tpu_torch.calib.recon import ReconConfig, recon_data  # noqa: F401
from dfq_tpu_torch.calib.distill_correct import bias_correction_distill  # noqa: F401
