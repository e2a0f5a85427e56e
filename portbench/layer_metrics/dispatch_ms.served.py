from portbench.readings import dispatch_ms as read  # noqa: F401
