"""One torch thread in each test process.

The port's CPU tests run the kernels' plain PyTorch versions, thousands
of small operations each.  Under pytest-xdist every worker would open an
OpenMP team of one thread a core for them, so six workers put six times
the cores' threads on the host, and each operation's barrier waits for
threads the scheduler has parked: a test of 3 s alone took 640 s so.
Collection imports this module in every process, which caps torch's
intra-op threads at one there; the answers do not depend on it.
"""

import torch

torch.set_num_threads(1)


def test_torch_runs_one_intra_op_thread():
    assert torch.get_num_threads() == 1
