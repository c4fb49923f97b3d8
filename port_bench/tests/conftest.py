"""Fixtures of the benchmark's tests."""

import pytest


@pytest.fixture
def cuda_device():
  """The card; the test skips on a machine without one."""
  import torch
  if not torch.cuda.is_available():
    pytest.skip('needs a CUDA device')
  return torch.device('cuda')
