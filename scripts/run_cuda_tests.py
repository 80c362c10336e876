"""Run the port's ``cuda``-marked tests on a machine that has a CUDA card
but no JAX.

The port's test files import both packages, since their CPU tests hold
the port against the JAX package; the ``cuda``-marked tests compare the
hand-written kernels with their plain PyTorch versions and call nothing
of JAX.  This script stands mocks in for the JAX modules, so the test
files import, and runs only the ``cuda``-marked tests:

    PYTHONPATH=src python scripts/run_cuda_tests.py tests/test_torch_*.py

Extra arguments go to pytest.  On a machine without a card every
selected test skips.
"""
from __future__ import annotations

import sys
from unittest import mock

JAX_MODULES = ("jax", "jax.numpy", "jax.lax", "jax.random", "jax.nn",
               "jax.tree_util", "jax.sharding", "jax.experimental",
               "jax.experimental.pallas", "jax.experimental.pallas.tpu",
               "jax.experimental.shard_map", "jax.experimental.mesh_utils",
               "jaxlib")


def main(argv) -> int:
    for name in JAX_MODULES:
        sys.modules[name] = mock.MagicMock(name=name)
    import pytest
    return pytest.main(["-q", "-m", "cuda", "-p", "no:cacheprovider",
                        "-rs", *argv])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
