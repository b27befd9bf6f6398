"""The share of the traced serving window in which no operation ran on
the card: 100 (1 - busy / window)."""


def read(window):
    return 100.0 * (1.0 - window.busy_s / window.window_s)
