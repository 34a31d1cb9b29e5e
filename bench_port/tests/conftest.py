"""The benchmark's tests: ``python -m pytest bench_port/tests`` from the
root of the repository (no JAX needed).  Tests marked ``cuda`` need an
NVIDIA card and skip, inside their fixture, where there is none."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

# the configuration's widths cut for the CPU: a 8 x 8 grid (a 2 x 2
# deformed grid), narrow tokens and omics
SMALL = {"fixdim": 64, "input_path_dim": 64, "path_dim": 32,
         "omic_dim": 32, "input_size_omic": 40, "input_size_omic_tumor": 10,
         "input_size_omic_immune": 30}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def manifest():
    from bench_port import harness

    return harness.load_manifest()
