"""A fixture for the port's CPU test files: one torch intra-op thread.

The port's plain CPU training is many small torch ops.  One thread runs
them at least as fast as the default when a file runs alone, and test
files running side by side in worker processes (``pytest -n``) then do
not fight over the host's cores: with the default thread count each,
one example run as written took 24 times as long under six workers as
alone.  Importing ``one_torch_thread`` into a test module makes it apply
to that module.
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
