from portbench.spans import nms_host_syncs as read  # noqa: F401
