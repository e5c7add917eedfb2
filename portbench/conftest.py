"""pytest settings of the benchmark's own tests (portbench/tests).

    python3 -m pytest portbench/tests -q                 # on the CPU
    python3 -m pytest portbench/tests -q -m card         # on the card

Tests marked `card` need an NVIDIA card; each decides inside the test
whether there is one and skips with a reason where there is none.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (skips without one)")
