from portbench.readings import batch_fill_pct as read  # noqa: F401
