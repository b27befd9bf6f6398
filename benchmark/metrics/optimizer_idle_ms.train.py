"""ms a training step inside the program's ``xd/optimizer`` span (SGD
with momentum and the EMA shadow's update) in which no operation ran on
the card."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "optimizer")
