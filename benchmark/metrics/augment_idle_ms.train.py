"""ms a training step inside the program's ``xd/augment`` span (crop
sampling, resize, colour distortion) in which no operation ran on the
card."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "augment")
