"""How many threads torch runs on in the port's tests; every test_torch_*
module imports this one.

Under pytest-xdist each worker gets its share of the cores, at least one:
torch's default pool is one thread a core in every worker, so six workers
oversubscribe the cores, and a test that takes 5 s alone took 90-110 s
beside the others.  A run in one process keeps torch's default."""
import os

import torch

WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // WORKERS))
THREADS = torch.get_num_threads()


def test_threads_are_the_workers_share():
    assert torch.get_num_threads() == THREADS
    if WORKERS > 1:
        assert THREADS * WORKERS <= max(WORKERS, len(os.sched_getaffinity(0)))
