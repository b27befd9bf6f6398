"""Device ms a batch of the operations launched inside the benchmark's
``bench/backbone`` range (the program's backbone module's forward)."""


def read(window):
    s = window.device_s_under(lambda name: name == "bench/backbone")
    return s * 1e3 / window.units if s > 0 else None
