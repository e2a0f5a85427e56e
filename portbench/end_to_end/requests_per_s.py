"""Requests whose result row was on the host by the window's end, over the
window's length: the rate the system serves under an open loop offered
above it."""


def read(r):
    return r["completed_in_window"] / r["window_s"] if "completed_in_window" in r else None
