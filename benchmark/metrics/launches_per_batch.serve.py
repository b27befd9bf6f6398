"""Kernels launched a batch: the traced kernels whose launch (a runtime
call, tied by its correlation id) lies in the window, over its batches."""


def read(window):
    return window.launches() / window.units
