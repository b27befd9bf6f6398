"""Device ms a training step of the operations launched while the
program's ``xd/backward`` span was open: autograd's backward, which
launches from autograd's device thread while the span is open on the
caller's."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.device_ms_launched_in(window, "backward")
