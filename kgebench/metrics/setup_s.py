"""Seconds from the start of the run to the first timed step: the kernels'
build or load, the graph, the tables, the checked steps and the warm-up."""


def read(rec):
    return rec.setup_s
