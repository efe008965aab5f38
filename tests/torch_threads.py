"""One intra-op thread for the port's CPU tests.

The tier-1 suite runs in several pytest-xdist processes on a machine of
a few cores, and some tests start gloo ranks beside them. PyTorch's
default of one intra-op thread a core in each process oversubscribes the
cores several times over, and the port's tests (small tensors through
many operators) then ran four to seven times slower than each file run
alone. The port's CPU test modules import this module, so a test
process runs one thread whichever of them is collected first; the ranks
take one thread each too (``sharding_selftest.start``).
"""
import torch

torch.set_num_threads(1)
