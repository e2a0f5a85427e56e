from dfq_tpu_torch.models.common import init_params, load_torch_state_dict  # noqa: F401
from dfq_tpu_torch.models.mobilenet_v2 import mobilenet_v2  # noqa: F401
from dfq_tpu_torch.models.resnet import resnet18  # noqa: F401
from dfq_tpu_torch.models.alexnet import alexnet  # noqa: F401
from dfq_tpu_torch.models.deeplab import (  # noqa: F401
    deeplab_mobilenet_v2,
    deeplab_drn,
    deeplab_resnet101,
    deeplab_xception,
)
from dfq_tpu_torch.models.ssd import SSDConfig, mobilenet_v2_ssd_lite  # noqa: F401
from dfq_tpu_torch.models.ssd_variants import (  # noqa: F401
    fpn_mobilenet_v1_ssd,
    mobilenet_v1_ssd,
    mobilenet_v1_ssd_lite,
    squeezenet_ssd_config,
    squeezenet_ssd_lite,
    vgg16_ssd,
    vgg_ssd_config,
)
