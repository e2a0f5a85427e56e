from dfq_tpu_torch.quant.core import (  # noqa: F401
    dequantize_int,
    fake_quant,
    fake_quant_np,
    fake_quant_per_channel,
    quant_params,
    quantize_int,
)
from dfq_tpu_torch.quant.moments import (  # noqa: F401
    relu6_gaussian_mean,
    relu6_gaussian_var,
    relu_gaussian_mean,
    relu_gaussian_var,
)
