"""Set-up time: process start to the schedule's start (weights, model,
engine, kernels loaded or built, the cell's shapes warmed)."""


def read(rec):
    return rec.setup_s
