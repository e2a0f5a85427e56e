from portbench.readings import mfu_pct as read  # noqa: F401
