from portbench.readings import idle_share_pct as read  # noqa: F401
