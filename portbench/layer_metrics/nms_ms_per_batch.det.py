from portbench.readings import nms_ms_per_batch as read  # noqa: F401
