"""ms a served batch inside the program's ``xd/proposals`` span (the
proposal stage: softmax, decode, top-k, NMS and its host checks) in which
no operation ran on the card."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.idle_ms(window, "proposals")
