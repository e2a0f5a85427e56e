"""Seconds from the process's start to the first timed step: graph, seeded
weights, DFQ passes, int8 lowering, packing, kernel load or build,
inputs, and warming the cell's own shapes."""


def read(r):
    return r["setup_s"]
