"""ms a training step inside the program's ``xd/proposals`` span (the
training budgets' proposal stage and its NMS) in which no operation ran on
the card."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "proposals")
