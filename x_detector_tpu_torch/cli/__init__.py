"""Command-line entry points: ``python -m x_detector_tpu_torch.cli.train``,
``.cli.evaluate``, ``.cli.convert_voc``, ``.cli.export`` and
``.cli.predict``."""
