"""Command-line entry points: ``python -m x_detector_tpu_torch.cli.train``
and ``python -m x_detector_tpu_torch.cli.evaluate``."""
