"""The port's streaming-HVP L-BFGS (``mctm_fit``, ``method="lbfgs"``) against
the JAX package's, on the CPU: the same seeded data and the same initial
parameters (the JAX init carried across with ``params_from_numpy``) through
both packages' ``fit_mctm_streaming(method="lbfgs")``, 150 iterations: the
first 5 losses agree to rtol 1e-5 and ``final_nll`` to 1e-4 relative.
Measured: ≤ 6e-7 and ≤ 2e-6 (n = 1,000, chunk 128) — both fits sum f32
microbatch losses and gradients in another order, and the line searches'
accepted steps move by as much further on; the iterates reconverge near the
optimum. The rest of the L-BFGS tests are in ``test_torch_lbfgs.py``."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import mctm as RM  # noqa: E402
from repro.core import mctm_fit as RF  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro_torch.core import bernstein as TB  # noqa: E402
from repro_torch.core import mctm as TM  # noqa: E402
from repro_torch.core import mctm_fit as TF  # noqa: E402

CFG = dict(J=2, degree=5)


def _gaussian(n, seed=0, rho=0.7):
    rng = np.random.default_rng(seed)
    L = np.linalg.cholesky(np.array([[1, rho], [rho, 1]]))
    Y = (rng.standard_normal((n, 2)) @ L.T).astype(np.float32)
    scaler = DataScaler.fit(Y)
    return Y, scaler, TB.DataScaler(low=scaler.low, high=scaler.high)


def _port(p):
    return TM.params_from_numpy(np.asarray(p.theta_raw), np.asarray(p.lam), device="cpu")


@pytest.mark.parametrize("chunk,weighted", [(128, False), (0, False), (256, True)])
def test_lbfgs_matches_reference(chunk, weighted):
    Y, scaler, tscaler = _gaussian(n=1000)
    w = np.random.default_rng(1).uniform(0.5, 3.0, 1000).astype(np.float32) if weighted else None
    init = RM.init_params(jax.random.PRNGKey(3), RM.MCTMConfig(**CFG))
    ref = RF.fit_mctm_streaming(RM.MCTMConfig(**CFG), scaler, Y, w, init=init, steps=150,
                                method="lbfgs", chunk_size=chunk)
    got = TF.fit_mctm_streaming(TM.MCTMConfig(**CFG), tscaler, Y, w, init=_port(init), steps=150,
                                method="lbfgs", chunk_size=chunk, device="cpu")
    assert got.losses.shape == ref.losses.shape == (150,)
    np.testing.assert_allclose(got.losses[:5], ref.losses[:5], rtol=1e-5)
    assert abs(got.final_nll - ref.final_nll) <= 1e-4 * abs(ref.final_nll)
