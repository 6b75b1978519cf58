"""One torch thread while a port test module runs: imported by every
``tests/test_torch_*.py`` that runs torch in the test process (an autouse
fixture is picked up from the module's namespace)."""

import pytest

torch = pytest.importorskip("torch")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread while a module's tests run: under pytest-xdist
    every worker's torch would otherwise spin a thread a core on shared
    cores, which these small-tensor tests pay for many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
