"""One intra-op thread for the port's CPU tests.

The port's tests push small shapes through many small torch ops. On the CPU
each op's parallel region costs more than it saves, and the idle OpenMP
threads spin on cores that the test workers beside them (the JAX package's
tests, under xdist) need. A test module that imports ``one_torch_thread``
runs its tests on one intra-op thread, and the count is restored after the
module. Results do not depend on it beyond the order of f32 sums, which
every comparison's tolerance covers.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_a_module_that_imports_the_fixture_runs_on_one_thread():
    assert torch.get_num_threads() == 1
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4096, 64)).astype(np.float32))
    np.testing.assert_allclose(x.sum(0).numpy(), x.double().sum(0).numpy(), rtol=1e-4, atol=1e-4)
