"""The harness's tests: run with ``python -m pytest perfbench/tests -q``.
Tests marked ``gpu`` need a CUDA device and skip without one."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.fixture(scope="session")
def manifest():
    from perfbench.manifest import Manifest

    return Manifest(ROOT)
