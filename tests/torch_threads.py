"""One torch thread a pytest-xdist worker, for the port's CPU tests.

With torch's default of a thread a core in every worker, the workers
oversubscribe the machine and the port's CPU tests take about twice as
long (six port test files on six workers of an 8-core machine: 98 s with
the default, 49 s with one thread).  Every ``tests/test_torch_*.py``
imports this module; outside a pytest-xdist worker it changes nothing.
"""

import os

import torch

if os.environ.get("PYTEST_XDIST_WORKER"):
    torch.set_num_threads(1)
