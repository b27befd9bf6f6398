"""Kernel B2's share of its roofline: the least time of a batch's fused
separable calls (the frozen ``sepconv_work`` over the data sheet's peaks)
over the device time of the operations launched inside the operator
``xdt::fused_sepconv``.

Nothing from a window that lost kernels: its time would fall short of
the work counted."""


def read(window):
    bound = window.info.get("b2_bound_ms_per_unit")
    s = window.device_s_under(lambda name: name == "xdt::fused_sepconv")
    if not bound or s <= 0 or window.lost:
        return None
    return 100.0 * bound * window.units / (s * 1e3)
