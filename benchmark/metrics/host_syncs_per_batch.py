"""Device-to-host waits a batch: runtime calls in the window that block
the host on the card (stream, device or event synchronisations and
synchronous copies), over its batches."""


def read(window):
    return window.syncs() / window.units
