"""Seconds from the start of the benchmark's process to the first timed
call: inputs, the program's quantizer and pipeline build (nvcc on a first
run), warm-up."""


def read(run):
    return run.setup_s
