from dfq_tpu_torch.io.artifact import load_artifact, save_artifact  # noqa: F401
