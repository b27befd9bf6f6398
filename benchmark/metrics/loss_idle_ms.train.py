"""ms a training step inside the program's ``xd/loss`` span (anchor and
proposal matching, RPN sampling, the RPN and OHEM losses) in which no
operation ran on the card."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "loss")
