from dfq_tpu_torch.models.common import init_params, load_torch_state_dict  # noqa: F401
from dfq_tpu_torch.models.mobilenet_v2 import mobilenet_v2  # noqa: F401
from dfq_tpu_torch.models.resnet import resnet18  # noqa: F401
from dfq_tpu_torch.models.deeplab import deeplab_mobilenet_v2  # noqa: F401
from dfq_tpu_torch.models.ssd import mobilenet_v2_ssd_lite  # noqa: F401
