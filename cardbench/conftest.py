"""The benchmark's CPU tests import its modules by their plain names (as
``run.py`` does, run as a script) and the port from ``src/``."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.join(os.path.dirname(HERE), "src"), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)
