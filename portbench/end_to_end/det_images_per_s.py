from portbench.readings import images_per_s as read  # noqa: F401
