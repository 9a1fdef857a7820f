"""One intra-op thread for every process that runs the PyTorch port's tests.

Imported by each ``tests/test_torch_*.py`` (directly or through
``_torch_parity``) and by the worker processes those tests start. This file
imports torch only, so the tests that run without JAX may import it.
"""

import torch

# The CPU tests run many small operations, in several test processes at once:
# a pool of one thread per core in each process only contends.
torch.set_num_threads(1)
