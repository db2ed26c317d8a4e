"""Each kernel's plain PyTorch version (``repro_torch/kernels/*/ref.py``, the
CPU path of the port) against the JAX package's Pallas kernel run with
``interpret=True`` on the same numpy inputs.

Tolerances: gram rtol 1e-5 of max|G| (f32 sums in another order); extremes
values atol 1e-4 with exact indices (the reference's tests/test_kernels.py);
sweep SX and z atol/rtol 1e-6, moments atol 1e-4, exact indices (the
reference's tests/test_sweep_kernel.py::_check); bernstein atol 1e-6.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.scoring import sketch_plan  # noqa: E402
from repro.kernels.bernstein.ops import bernstein_basis_deriv  # noqa: E402
from repro.kernels.extremes.ops import directional_extremes  # noqa: E402
from repro.kernels.gram.ops import gram_matrix  # noqa: E402
from repro.kernels.sweep.ops import fused_sweep_update  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402
from repro_torch.kernels.bernstein import ops as tbern  # noqa: E402
from repro_torch.kernels.extremes import ops as text  # noqa: E402
from repro_torch.kernels.extremes.ref import directional_extremes_ref  # noqa: E402
from repro_torch.kernels.gram import ops as tgram  # noqa: E402
from repro_torch.kernels.gram.ref import gram_ref  # noqa: E402
from repro_torch.kernels.sweep import ops as tsweep  # noqa: E402
from repro_torch.kernels.sweep.ref import fused_sweep_ref  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n,degree", [(100, 6), (2049, 4)])
def test_bernstein_ref_matches_pallas_kernel(n, degree):
    t = np.random.default_rng(n).random(n).astype(np.float32)
    basis, deriv = bernstein_basis_deriv(jnp.asarray(t), degree, interpret=True)
    bounds = torch.tensor([[0.0], [1.0], [1.0]])
    A, Ap = tbern.bernstein_featurize(_t(t)[:, None], bounds, degree)
    np.testing.assert_allclose(A[:, 0].numpy(), np.asarray(basis), atol=1e-6)
    np.testing.assert_allclose(Ap[:, 0].numpy(), np.asarray(deriv), atol=1e-6)


@pytest.mark.parametrize("n,D", [(64, 4), (777, 14), (300, 64)])
@pytest.mark.parametrize("weighted", [False, True])
def test_gram_ref_matches_pallas_kernel(n, D, weighted):
    rng = np.random.default_rng(n + D)
    X = rng.standard_normal((n, D)).astype(np.float32)
    sw = np.sqrt(rng.uniform(0.2, 2.0, n)).astype(np.float32) if weighted else None
    Xw = X if sw is None else X * sw[:, None]
    ref = np.asarray(gram_matrix(jnp.asarray(Xw), interpret=True))
    got = tgram.gram_matrix(_t(X), None if sw is None else _t(sw)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n,D", [(0, 14), (1, 14), (777, 14), (300, 64)])
@pytest.mark.parametrize("weighted", [False, True])
def test_gram_ref_accumulator_equals_the_separate_add(n, D, weighted):
    """gram_matrix(X, sw, acc=G) on the plain version has the bits of
    G + gram_ref(X, sw), and matches the Pallas kernel's Gram added to G
    (1e-5 of max|G|, as above)."""
    rng = np.random.default_rng(n + 3 * D)
    X = rng.standard_normal((n, D)).astype(np.float32)
    sw = np.sqrt(rng.uniform(0.2, 2.0, n)).astype(np.float32) if weighted else None
    acc = (rng.standard_normal((D, D)) * 1e3).astype(np.float32)  # not symmetric
    tsw = None if sw is None else _t(sw)
    got = tgram.gram_matrix(_t(X), tsw, acc=_t(acc))
    assert torch.equal(got, _t(acc) + tgram.gram_matrix(_t(X), tsw))
    assert torch.equal(got, _t(acc) + gram_ref(_t(X), tsw))
    Xw = X if sw is None else X * sw[:, None]
    # the Pallas kernel takes no empty chunk: there the sum is acc itself
    ref = acc + np.asarray(gram_matrix(jnp.asarray(Xw), interpret=True)) if n else acc
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


def _extremes_case(rows, m, d, seed, tie):
    rng = np.random.default_rng(seed)
    P = rng.standard_normal((rows, d)).astype(np.float32)
    if tie:  # the second half copies the first: every extreme ties exactly
        P[rows // 2: 2 * (rows // 2)] = P[: rows // 2]
    dirs = rng.standard_normal((m, d)).astype(np.float32)
    return P, dirs


@pytest.mark.parametrize("rows,m,d,n_valid,tie", [
    (64, 8, 5, 64, False),
    (777, 24, 7, 700, False),     # ragged validity
    (1030, 130, 7, 1030, True),   # exact ties: first occurrence wins
    (1030, 40, 14, 517, True),
])
def test_extremes_ref_matches_pallas_kernel(rows, m, d, n_valid, tie):
    P, dirs = _extremes_case(rows, m, d, rows + m, tie)
    mask = jnp.arange(rows) < n_valid
    ref = directional_extremes(jnp.asarray(P), jnp.asarray(dirs), mask, interpret=True)
    got = text.directional_extremes(_t(P), _t(dirs), n_valid)
    for g, r, name in zip(got, ref, ("vmax", "imax", "vmin", "imin")):
        if name.startswith("i"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
            assert int(g.max()) < n_valid
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-4, err_msg=name)
    if tie:
        assert int(got[1].max()) < rows // 2 and int(got[3].max()) < rows // 2


def _sweep_case(c, D, d, r, m, sk, q, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((c, D)).astype(np.float32)
    P = rng.standard_normal((c * r, d)).astype(np.float32)
    dirs = rng.standard_normal((m, d)).astype(np.float32) if m else None
    sw = (rng.random(c) + 0.5).astype(np.float32)
    omega = rng.standard_normal((D, q)).astype(np.float32) if q else None
    rows, signs = sketch_plan(jax.random.PRNGKey(seed), c, sk)
    SX = rng.standard_normal((sk, D)).astype(np.float32)
    return SX, X, P, sw, np.asarray(rows), np.asarray(signs), dirs, omega


@pytest.mark.parametrize("c,r,m,q,n_valid,moments,want_z", [
    (517, 2, 33, 5, 480, True, True),
    (517, 1, 0, None, 517, True, False),
    (1025, 2, 130, 8, 1000, True, True),
])
def test_sweep_ref_matches_pallas_kernel(c, r, m, q, n_valid, moments, want_z):
    D, d, sk = 14, 7, 64
    SX, X, P, sw, rows, signs, dirs, omega = _sweep_case(c, D, d, r, m, sk, q, c + m)
    mom = (np.zeros(d, np.float32), np.zeros((d, d), np.float32)) if moments else None
    j = lambda a: None if a is None else jnp.asarray(a)  # noqa: E731
    ref = fused_sweep_update(
        j(SX), j(X), j(P), j(sw), j(rows), j(signs), dirs=j(dirs), omega=j(omega),
        mask=jnp.arange(c) < n_valid, moments=None if mom is None else tuple(map(j, mom)),
        want_z=want_z, interpret=True,
    )
    tt = lambda a: None if a is None else _t(a)  # noqa: E731
    got = tsweep.fused_sweep_update(
        _t(SX), _t(X), _t(P), _t(sw), _t(rows), _t(signs), dirs=tt(dirs), omega=tt(omega),
        n_valid=n_valid, moments=None if mom is None else tuple(map(_t, mom)), want_z=want_z,
    )
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-6, atol=1e-6)
    assert (got[1] is None) == (ref[1] is None)
    if want_z:
        np.testing.assert_allclose(got[1].numpy(), np.asarray(ref[1]), rtol=1e-6, atol=1e-6)
    assert (got[2] is None) == (ref[2] is None)
    if m:
        for g, rr, name in zip(got[2], ref[2], ("vmax", "imax", "vmin", "imin")):
            if name.startswith("i"):
                np.testing.assert_array_equal(g.numpy(), np.asarray(rr), err_msg=name)
            else:
                np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=1e-6, atol=1e-6)
    if moments:
        for g, rr in zip(got[3], ref[3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(rr), rtol=1e-6, atol=1e-4)


def test_fused_sweep_ref_matches_unfused_composition():
    """The fused plain version equals the unfused per-accumulator steps it
    replaces (scoring._sketch_update, _weighted_project, the extremes)."""
    c, D, d, r, m, sk, q = 400, 14, 7, 2, 30, 50, 6
    SX, X, P, sw, rows, signs, dirs, omega = (
        None if a is None else _t(a) for a in _sweep_case(c, D, d, r, m, sk, q, 7)
    )
    s0 = (torch.zeros(d), torch.zeros(d, d))
    SXf, z, ext, mom = fused_sweep_ref(SX, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                                       moments=s0)
    SXu, s1, s2 = TS._sketch_update(SX, *s0, X, P, sw, rows, signs)
    torch.testing.assert_close(SXf, SXu, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(z, TS._weighted_project(X, sw, omega), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(mom[0], s1)
    torch.testing.assert_close(mom[1], s2)
    for a, b in zip(ext, directional_extremes_ref(P, dirs)):
        torch.testing.assert_close(a, b)


@pytest.mark.parametrize("op", ["gram", "extremes", "sweep", "bernstein"])
def test_wrappers_refuse_unknown_or_mismatched_backend(op):
    X = torch.zeros(4, 3)
    calls = {
        "gram": lambda b: tgram.gram_matrix(X, backend=b),
        "extremes": lambda b: text.directional_extremes(X, X, backend=b),
        "sweep": lambda b: tsweep.fused_sweep_update(
            torch.zeros(2, 3), X, None, torch.ones(4), torch.zeros(4, dtype=torch.int32),
            torch.ones(4), backend=b),
        "bernstein": lambda b: tbern.bernstein_featurize(X[:, :1], torch.ones(3, 1), 2, backend=b),
    }
    calls[op]("torch")  # the CPU tensor's own path
    with pytest.raises(ValueError, match="unknown"):
        calls[op]("pallas")
    with pytest.raises(ValueError, match="does not run"):
        calls[op]("cuda")  # a CPU tensor never reaches the kernel
