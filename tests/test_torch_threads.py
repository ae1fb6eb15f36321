"""Torch's intra-op thread pool, one thread in each xdist worker, for
every test file of the port.

Under ``pytest -n N`` each of the N workers ran torch's intra-op pool
sized to all the machine's cores, so N pools contended for them.  On an
8-core machine the whole suite under ``-n 6 --dist loadfile`` took
1,261 s with the default pools and 562 s with one thread a worker (the
``fused`` setup of ``test_torch_kv_quant.py`` 202 s against 68 s), the
same tests failing and no other.  Every worker imports every test module when it
collects, so this one call, at module level, reaches every test the
worker runs.

One thread, not the cores over the workers: the thread count sets the
order of torch's float32 sums on the CPU, and the suite's tolerances
against the reference hold at one thread and at a whole machine's, but
not at every count between (``test_torch_train.py::
test_strategy_round_matches_reference[elastic-sgd]`` misses by one
element of 3,840 at two).  One thread keeps the order the same on any
machine.  A run without xdist (one file, or ``pytest -x -q``) keeps
torch's default.
"""
import os

import pytest

torch = pytest.importorskip("torch")


WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
DEFAULT_THREADS = torch.get_num_threads()
if WORKERS > 1:
    torch.set_num_threads(1)


def test_intra_op_threads_are_one_in_each_xdist_worker():
    want = 1 if WORKERS > 1 else DEFAULT_THREADS
    assert torch.get_num_threads() == want
