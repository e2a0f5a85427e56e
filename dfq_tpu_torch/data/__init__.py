from dfq_tpu_torch.data.imagenet import imagenet_batches, list_val_set, load_image  # noqa: F401
