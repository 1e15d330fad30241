"""Tally primitives: binned_add / drop_add drop and accumulate semantics."""

import numpy as np
import jax.numpy as jnp
import pytest

from skirt_tpu.ops import binned_add, drop_add


class TestDropAdd:
    def test_negative_dropped_positive_oob_dropped(self):
        t = jnp.zeros(6)
        out = np.asarray(drop_add(t, jnp.asarray([0, -1, 5, 6, -3]),
                                  jnp.asarray([1.0, 10.0, 2.0, 20.0, 30.0])))
        assert out.tolist() == [1.0, 0, 0, 0, 0, 2.0]


# (indices, values, expected tally of length 6)
_CASES = {
    "minus_one_dropped": ([0, -1, 2], [1.0, 5.0, 2.0],
                          [1, 0, 2, 0, 0, 0]),
    "out_of_range_dropped": ([5, 6, 100], [1.0, 7.0, 9.0],
                             [0, 0, 0, 0, 0, 1]),
    "duplicates_accumulate": ([3, 3, 3, 1], [1.0, 2.0, 4.0, 0.5],
                              [0, 0.5, 0, 7, 0, 0]),
    "two_d_indices": ([[0, 1, -1], [1, 6, 5]], [[1.0, 2.0, 3.0],
                                                [4.0, 5.0, 6.0]],
                      [1, 6, 0, 0, 0, 6]),
}


@pytest.mark.parametrize("fn", [drop_add, binned_add],
                         ids=["drop_add", "binned_add"])
@pytest.mark.parametrize("case", sorted(_CASES))
def test_scatter_semantics(fn, case):
    idx, val, want = _CASES[case]
    out = fn(jnp.zeros(6, jnp.float32), jnp.asarray(idx, jnp.int32),
             jnp.asarray(val, jnp.float32))
    np.testing.assert_allclose(np.asarray(out), want)


def test_binned_add_accumulates_onto_existing_tally():
    t = jnp.arange(4, dtype=jnp.float32)
    out = binned_add(t, jnp.asarray([1, -1, 3]), jnp.asarray([1.0, 1.0, 2.0]))
    np.testing.assert_allclose(np.asarray(out), [0, 2, 2, 5])
