from portbench.replay_share import replay_share_pct as read  # noqa: F401
