from dfq_tpu_torch.passes.fold_bn import fold_batchnorm  # noqa: F401
from dfq_tpu_torch.passes.relations import Relation, create_relations  # noqa: F401
from dfq_tpu_torch.passes.equalize import cross_layer_equalization  # noqa: F401
from dfq_tpu_torch.passes.absorb import bias_absorption  # noqa: F401
from dfq_tpu_torch.passes.correct import bias_correction  # noqa: F401
from dfq_tpu_torch.passes.clip import clip_weights  # noqa: F401
from dfq_tpu_torch.passes.weight_quant import quantize_layer_weights  # noqa: F401
from dfq_tpu_torch.passes.range_setter import set_quant_ranges  # noqa: F401
from dfq_tpu_torch.passes.learned_scale import learn_scales  # noqa: F401
