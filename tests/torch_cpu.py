"""A fixture shared by the port's CPU tests whose torch work is many small
operations (`tests/test_torch_{sgvb,fagioli,chickpea}.py` and the faba
lineage / annotate / model-stack parity files).

torch's CPU operators split work over a team of threads (one per core)
and wait for it at every call. When the test workers share the cores,
each such wait stalls behind the other workers: on an 8-core x86 host one
800-step SuSiE fit took 93 s beside six busy processes and 7.9 s there on
one thread, against 8.7 s alone on eight. Importing `one_torch_thread` into a test module runs
that module's torch work on one thread; the count is restored after it.
"""

import contextlib

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@contextlib.contextmanager
def one_thread():
    """torch on one thread inside the block: two runs of a command are
    bit-equal there (on several threads its CPU sums may part in the last
    bits from run to run)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
