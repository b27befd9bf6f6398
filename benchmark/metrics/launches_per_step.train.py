"""Kernels launched a training step: the traced kernels whose launch (a
runtime call, tied by its correlation id) lies in the window, over its
steps."""


def read(window):
    return window.launches() / window.units
