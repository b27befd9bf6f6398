"""ms a served batch inside the program's ``xd/postprocess`` span (the
NMS tail: decode and per-class NMS after the model's forward) in which no
operation ran on the card."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "postprocess")
