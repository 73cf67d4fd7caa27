"""Seconds from the start of the process to the first timed step: imports,
the kernels' build or load, the batch, the seeded weights and the set-up's
checked steps, which warm every shape the window uses."""


def read(rec):
    return rec["setup_s"]
