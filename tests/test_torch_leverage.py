"""Leverage scores of the port against the JAX package's, on the same seeded
inputs: rtol 1e-3 / atol 1e-4 (the reference's own tolerance in
tests/test_leverage.py) for the Gram forms on Bernstein features, whose
pseudo-inverse is ill conditioned, and for the QR form; rtol 1e-5 for the
well-conditioned full-rank and ridge cases; the CountSketch estimate fed the
reference's own randint/rademacher draws; block_B_matrix exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import leverage as RL  # noqa: E402
from repro.core.bernstein import DataScaler  # noqa: E402
from repro.core.mctm import MCTMConfig, basis_features  # noqa: E402
from repro_torch.core import leverage as TL  # noqa: E402


def _features(n=300, J=2, degree=6, seed=0):
    rng = np.random.default_rng(seed)
    Y = rng.standard_normal((n, J))
    A, _ = basis_features(MCTMConfig(J=J, degree=degree), DataScaler.fit(Y), jnp.asarray(Y))
    return np.asarray(A)


def _gaussian(n=400, D=8, seed=1):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(np.float32)


def test_block_b_and_flatten_match_reference():
    A = _features(n=20, J=3, degree=3)
    np.testing.assert_array_equal(TL.block_B_matrix(A), RL.block_B_matrix(A))
    got = TL.flatten_features(torch.tensor(A)).numpy()
    np.testing.assert_array_equal(got, np.asarray(RL.flatten_features(jnp.asarray(A))))


@pytest.mark.parametrize("case", ["bernstein", "gaussian"])
@pytest.mark.parametrize("fn", ["gram", "root", "qr"])
def test_exact_leverage_matches_reference(case, fn):
    X = _features().reshape(300, -1) if case == "bernstein" else _gaussian()
    if fn == "qr" and case == "bernstein":
        # each block is a partition of unity: the full basis is rank
        # deficient, where QR leverage is ill-defined
        X = X[:, 1:]
    ref = {"gram": RL.leverage_scores_gram, "root": RL.root_leverage_scores,
           "qr": RL.leverage_scores_qr}[fn](jnp.asarray(X))
    got = {"gram": TL.leverage_scores_gram, "root": TL.root_leverage_scores,
           "qr": TL.leverage_scores_qr}[fn](X, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (X.shape[0],)
    rtol = 1e-3 if case == "bernstein" else 1e-5
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=1e-4)


@pytest.mark.parametrize("reg", [1e-3, 1.0, 10.0])
def test_ridge_leverage_matches_reference(reg):
    X = _features().reshape(300, -1)
    ref = np.asarray(RL.ridge_leverage_scores(jnp.asarray(X), reg=reg))
    got = TL.ridge_leverage_scores(X, reg=reg, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5 if reg >= 1.0 else 1e-3, atol=1e-6)


@pytest.mark.parametrize("rcond", [1e-6, 1e-3])
def test_leverage_from_gram_thresholds_like_reference(rcond):
    """The same G in, the same eigen-threshold out: modes ≤ rcond·max|w|
    are dropped on both sides (the f32 eigh of the same bits)."""
    X = _features().reshape(300, -1)
    G = X.T.astype(np.float64) @ X
    G32 = G.astype(np.float32)
    ref = np.asarray(RL.leverage_from_gram(jnp.asarray(X), jnp.asarray(G32), rcond))
    got = TL.leverage_from_gram(X, G32, rcond, device="cpu").numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)
    assert got.sum() <= np.linalg.matrix_rank(G) + 1e-3


@pytest.mark.parametrize("chunk", [4096, 97])
def test_sketched_leverage_on_the_reference_plan(chunk):
    """The reference's own CountSketch draws (its key split into randint
    rows and rademacher signs) handed to the port: the same SX, so the same
    scores to rtol 1e-5 on full-rank data, chunked or not."""
    X = _gaussian(n=512, D=8)
    key, sk = jax.random.PRNGKey(3), 64
    k1, k2 = jax.random.split(key)
    rows = np.asarray(jax.random.randint(k1, (512,), 0, sk))
    signs = np.asarray(jax.random.rademacher(k2, (512,), dtype=jnp.float32))
    ref = np.asarray(RL.sketched_leverage(jnp.asarray(X), key, sk))
    got = TL.sketched_leverage(X, sk, plan=(rows, signs), chunk_size=chunk, device="cpu")
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-6)


def test_sketched_leverage_beyond_the_sweep_kernel_width(monkeypatch):
    """The sweep kernel takes X of any width (its old limit was D ≤ 160):
    at D = 161, float32 SX is built by the sweep wrapper, one call a chunk,
    never by ``countsketch_add``, and the scores match the reference's on
    its own plan to rtol 1e-4 (the same SX; the float32 products SXᵀSX
    differ in summation order)."""
    calls = []
    real = TL.fused_sweep_update

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return real(*args, **kwargs)

    def no_countsketch(*args, **kwargs):
        raise AssertionError("float32 SX goes through the sweep at any width")

    monkeypatch.setattr(TL, "fused_sweep_update", counted)
    monkeypatch.setattr(TL, "countsketch_add", no_countsketch)
    n, D, sk = 600, 161, 900
    X = _gaussian(n=n, D=D, seed=5)
    key = jax.random.PRNGKey(6)
    k1, k2 = jax.random.split(key)
    rows = np.asarray(jax.random.randint(k1, (n,), 0, sk))
    signs = np.asarray(jax.random.rademacher(k2, (n,), dtype=jnp.float32))
    ref = np.asarray(RL.sketched_leverage(jnp.asarray(X), key, sk))
    got = TL.sketched_leverage(X, sk, plan=(rows, signs), chunk_size=250, device="cpu")
    assert got.dtype == torch.float32
    assert calls == [(250, D), (250, D), (100, D)]
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-6)


def test_sketched_leverage_float64_and_generator():
    """float64 X sketches in float64 (``countsketch_add``), against the
    reference under x64 on its own plan; the generator path draws a plan of
    its own and is reproducible."""
    X = _gaussian(n=512, D=8).astype(np.float64)
    key, sk = jax.random.PRNGKey(4), 64
    with jax.enable_x64(True):
        k1, k2 = jax.random.split(key)
        rows = np.asarray(jax.random.randint(k1, (512,), 0, sk))
        signs = np.asarray(jax.random.rademacher(k2, (512,), dtype=jnp.float64))
        ref = np.asarray(RL.sketched_leverage(jnp.asarray(X), key, sk))
    got = TL.sketched_leverage(X, sk, plan=(rows, signs), chunk_size=200, device="cpu")
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=1e-12)
    a = TL.sketched_leverage(X[:, :4].astype(np.float32), 32,
                             generator=torch.Generator().manual_seed(0), device="cpu")
    b = TL.sketched_leverage(X[:, :4].astype(np.float32), 32,
                             generator=torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError):
        TL.sketched_leverage(X, sk, device="cpu")  # no plan, no generator
    with pytest.raises(ValueError):
        TL.sketched_leverage(X, sk, plan=(rows + sk, signs), device="cpu")
