"""The port's block-granular prefill-page writes (``model.
write_prefill_pages`` and ``write_prefill_pages_batched``) against the
JAX package's, on the CPU: the same seeded pools, KV and tables give
bit-equal pools, with short and empty tables padded with ``null_block``,
a bucket's pad rows past ``len(tables)``, ``pad_to`` wider than every
table, S cut to the tables' capacity and zero-padded up to it; all-empty
tables with ``pad_to=0`` write nothing; the one-request wrapper.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import model as JM
from repro_torch.models import model as M

# One intra-op thread: the suite runs in several pytest-xdist workers on
# one machine, where PyTorch's default pool (a thread per core) in every
# worker makes these tests' small CPU ops a hundred times slower.
torch.set_num_threads(1)

L, N, BT, H, D = 2, 12, 4, 2, 8        # layers, pool blocks, block tokens


def _pools(rng):
    return {k: rng.standard_normal((L, N, BT, H, D)).astype(np.float32)
            for k in ("k", "v")}


def _both(pools, kv, tables, **kw):
    want = JM.write_prefill_pages_batched(
        {k: jnp.asarray(v) for k, v in pools.items()},
        tuple(jnp.asarray(c) for c in kv), tables, **kw)
    got = M.write_prefill_pages_batched(
        {k: torch.from_numpy(v.copy()) for k, v in pools.items()},
        tuple(torch.from_numpy(c) for c in kv), tables, **kw)
    return want, got


@pytest.mark.parametrize("s, tables, kw", [
    # S 10 over 3 blocks of 4 (zero-padded), a short and an empty row,
    # and a bucket's pad row past len(tables)
    (10, [[3, 5, 7], [2], []], dict(null_block=11)),
    # S 9 cut to 2 blocks; pad_to widens every row to 4 blocks
    (9, [[1, 4], [6, 8], [9, 10]], dict(null_block=0, pad_to=4)),
    # one block a row, S longer than the capacity
    (7, [[2], [3], [4], [5]], dict(null_block=11)),
])
def test_batched_write_matches_jax(s, tables, kw):
    rng = np.random.default_rng(0)
    pools = _pools(rng)
    b = len(tables) + (1 if s == 10 else 0)
    kv = tuple(rng.standard_normal((L, b, s, H, D)).astype(np.float32)
               for _ in range(2))
    want, got = _both(pools, kv, tables, **kw)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
        assert not np.array_equal(got[key].numpy(), pools[key])


def test_empty_tables_write_nothing():
    rng = np.random.default_rng(1)
    pools = _pools(rng)
    kv = tuple(rng.standard_normal((L, 2, 5, H, D)).astype(np.float32)
               for _ in range(2))
    want, got = _both(pools, kv, [[], []], null_block=0)
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(), pools[key])
        np.testing.assert_array_equal(np.asarray(want[key]), pools[key])


def test_single_request_write_matches_jax():
    rng = np.random.default_rng(2)
    pools = _pools(rng)
    kv = tuple(rng.standard_normal((L, 1, 11, H, D)).astype(np.float32)
               for _ in range(2))
    want = JM.write_prefill_pages({k: jnp.asarray(v) for k, v in
                                   pools.items()},
                                  tuple(jnp.asarray(c) for c in kv),
                                  [6, 2, 9])
    got = M.write_prefill_pages({k: torch.from_numpy(v.copy())
                                 for k, v in pools.items()},
                                tuple(torch.from_numpy(c) for c in kv),
                                [6, 2, 9])
    for key in ("k", "v"):
        np.testing.assert_array_equal(got[key].numpy(),
                                      np.asarray(want[key]))
