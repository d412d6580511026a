"""One-hot table lookups must equal the plain gather bit for bit.

The lookup runs as a matmul pinned to full f32 precision; a reduced
precision (TF32 keeps 10 mantissa bits) would round the table values.
``1 + 2**-20`` is not representable in TF32, so it catches that.  (The
one value the matmul does not carry is the sign of a zero: -0.0 comes back
as +0.0, which no shading code distinguishes.)
"""

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer_tpu.ops.smallgather import MAX_ONEHOT_ROWS, TableLookup, lookup_columns


def _columns(m, rng):
    f = (1.0 + 2.0 ** -20) * rng.uniform(-3, 3, m).astype(np.float32)
    f[0] = np.float32(1.0 + 2.0 ** -20)
    f[1] = np.float32(3.4e38)
    f[2] = np.float32(1e-30)
    i = rng.integers(-(2 ** 23), 2 ** 23, m).astype(np.int32)
    b = rng.uniform(size=m) > 0.5
    return [jnp.asarray(f), jnp.asarray(i), jnp.asarray(b)]


@pytest.mark.parametrize("m", [3, 17, MAX_ONEHOT_ROWS])
def test_lookup_columns_bit_equal_to_gather(m):
    rng = np.random.default_rng(m)
    cols = _columns(m, rng)
    idx = jnp.asarray(rng.integers(0, m, 1000).astype(np.int32))
    assert TableLookup(idx, m).use_onehot
    got = lookup_columns(idx, cols)
    for g, c in zip(got, cols):
        want = np.asarray(c)[np.asarray(idx)]
        assert g.dtype == c.dtype
        np.testing.assert_array_equal(
            np.asarray(g).view(np.uint8), want.view(np.uint8)
        )


def test_large_table_uses_plain_gather():
    m = MAX_ONEHOT_ROWS + 1
    rng = np.random.default_rng(0)
    cols = _columns(m, rng)
    idx = jnp.asarray(rng.integers(0, m, 64).astype(np.int32))
    assert not TableLookup(idx, m).use_onehot
    for g, c in zip(lookup_columns(idx, cols), cols):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(c)[np.asarray(idx)])
