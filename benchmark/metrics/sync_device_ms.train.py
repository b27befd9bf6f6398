"""Device ms a data-parallel step on the first card of the operations
launched while the program's ``xd/sync`` span was open: the exchange's
flatten, the all-reduce (NCCL's kernel, spinning while it waits for the
slowest rank), the division and the copies back."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.device_ms_launched_in(window, "sync")
