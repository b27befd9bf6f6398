"""The benchmark's CPU tests import ``benchmark`` from the checkout's
root; run them from there: ``python -m pytest benchmark/tests``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
