"""The port's CPU tests run torch on one intra-op thread.

Every ``tests/test_torch_*.py`` imports this module.  The suite's run
holds six pytest workers on eight cores, each with its own JAX thread
pool beside torch's; torch's default of a thread a core then
oversubscribes the cores, and its threads' spinning starves the other
workers (one test file, six copies at once on an eight-core host: 283 s
with the default, 90 s with one thread).  The tests' tensors are tiny:
one thread loses nothing in a process of its own.
"""

import torch

torch.set_num_threads(1)
