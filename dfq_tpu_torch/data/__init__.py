from dfq_tpu_torch.data.imagenet import imagenet_batches, list_val_set, load_image  # noqa: F401
from dfq_tpu_torch.data.voc import VOCDetection, VOCSegmentation, fix_scale_crop  # noqa: F401
