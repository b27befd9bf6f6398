"""NMS's host checks of its fixpoint a served batch: the program's
``xd/nms.host_check`` spans (one a ``torch.equal`` in
``ops/nms.self_suppress``) in the window, over its batches."""

from benchmark.harness import program_spans


def read(window):
    return program_spans.count(window, "nms.host_check")
