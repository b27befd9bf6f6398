"""Kernel B1's backward's share of its roofline: the least time of a
step's call (the frozen ``psroi_work`` at the fp32 rate and HBM's) over the
device time of the operations launched inside the operator
``xdt::psroi_align_bwd`` (on the backward's thread).
Nothing from a window that lost kernels: its time would fall short of
the work counted."""


def read(window):
    bound = window.info.get("b1_bwd_bound_ms_per_unit")
    s = window.device_s_under(lambda name: name == "xdt::psroi_align_bwd")
    if not bound or s <= 0 or window.lost:
        return None
    return 100.0 * bound * window.units / (s * 1e3)
