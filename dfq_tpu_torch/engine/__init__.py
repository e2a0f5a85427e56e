from dfq_tpu_torch.engine.int8 import Int8Layer, Int8Model, lower_int8  # noqa: F401
from dfq_tpu_torch.engine.int8_fused import (  # noqa: F401
    Int8FusedNet,
    QTensor,
    auto_config,
    execute_int8_fused,
)
from dfq_tpu_torch.engine.int8 import Int8Net, execute_int8  # noqa: F401
from dfq_tpu_torch.engine.autotune import (  # noqa: F401
    autotune_dw_policy,
    dw_policy_candidates,
    model_signature,
)
