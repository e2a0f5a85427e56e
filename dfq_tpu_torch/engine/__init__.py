from dfq_tpu_torch.engine.int8 import Int8Layer, Int8Model, lower_int8  # noqa: F401
from dfq_tpu_torch.engine.int8_fused import Int8FusedNet, QTensor  # noqa: F401
from dfq_tpu_torch.engine.int8 import Int8Net, execute_int8  # noqa: F401
