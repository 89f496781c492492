"""A module-scoped fixture that runs a test module's PyTorch CPU ops on
one intra-op thread.

The port's vision tests run thousands of tiny eager ops per frame.  Under
the suite's parallel workers (several processes on the same cores) the
default intra-op thread pool of every process contends for the cores and
each tiny op pays for it; on one thread the ops run inline.  Import the
fixture into a test module to apply it there:

    from tests.torch_threads import one_intraop_thread  # noqa: F401
"""
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_intraop_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
