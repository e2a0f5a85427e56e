from portbench.readings import glue_ms_per_image as read  # noqa: F401
