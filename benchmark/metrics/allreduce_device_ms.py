"""Device ms a step of the collective kernels (NCCL's) on the first
card: the all-reduce of the gradients, BatchNorm statistics and metrics."""


def read(window):
    s = window.device_s_by_name(lambda name: "nccl" in name.lower())
    return s * 1e3 / window.units if s > 0 else None
