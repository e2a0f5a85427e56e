from portbench.readings import kernels_roofline_pct as read  # noqa: F401
