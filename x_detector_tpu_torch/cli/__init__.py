"""Command-line entry points: ``python -m x_detector_tpu_torch.cli.train``,
``.cli.evaluate`` and ``.cli.convert_voc``."""
