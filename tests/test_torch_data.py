"""The port's copies of the data generators (``repro_torch/data``) against
the JAX package's: the same arrays, bit for bit, for a few seeds and sizes
(covertype's 10 columns; equity at J = 10 and 20 stocks, and the default)."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.data import covertype as RC  # noqa: E402
from repro.data import equity as RE  # noqa: E402
from repro_torch.data import covertype as TC  # noqa: E402
from repro_torch.data import equity as TE  # noqa: E402


@pytest.mark.parametrize("n,seed", [(1, 0), (997, 3), (50_000, 0)])
def test_covertype_matches_reference(n, seed):
    got, ref = TC.generate_covertype(n, seed=seed), RC.generate_covertype(n, seed=seed)
    assert got.shape == ref.shape == (n, 10) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    assert TC.COVERTYPE_COLUMNS == RC.COVERTYPE_COLUMNS


@pytest.mark.parametrize("n,n_stocks,seed", [(10, 10, 0), (10_000, 10, 1), (4_999, 20, 2),
                                             (10_000, 20, 0), (300, 3, 5)])
def test_equity_matches_reference(n, n_stocks, seed):
    got = TE.generate_equity_returns(n, n_stocks=n_stocks, seed=seed)
    ref = RE.generate_equity_returns(n, n_stocks=n_stocks, seed=seed)
    assert got.shape == ref.shape == (n, n_stocks) and got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


def test_equity_default_matches_reference():
    np.testing.assert_array_equal(TE.generate_equity_returns(), RE.generate_equity_returns())
