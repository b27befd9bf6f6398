"""ms a data-parallel step inside the program's ``xd/sync`` span (the
exchange) in which no operation ran on the first card: the host launching
the flatten and the copies back."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "sync")
