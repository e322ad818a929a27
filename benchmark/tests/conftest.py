"""The benchmark's own tests: ``python -m pytest benchmark/tests -q --noconftest``
is not needed; this file only puts the checkout's root on ``sys.path``."""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
