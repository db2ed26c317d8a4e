"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes. Marked ``cuda``: they skip where no CUDA device is
present (run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``).
Tolerances are chip_smoke.py's: bernstein atol 1e-6; gram 1e-5 of max|G|;
extremes exact (same FMA chain on both sides); sweep 1e-6, moments atol 1e-4
against the plain version in float64."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _g(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("n,J,degree", [(1, 1, 0), (1000, 2, 6), (4099, 3, 15)])
def test_bernstein_kernel(dev, n, J, degree):
    from repro_torch.kernels.bernstein import ops, ref

    Y = (torch.randn(n, J, generator=_g(n)) * 3).to(dev)
    bounds = torch.tensor([[-6.0] * J, [6.0] * J, [1 / 12.0] * J], device=dev)
    before = ops.LAUNCHES
    A, Ap = ops.bernstein_featurize(Y, bounds, degree)
    assert ops.LAUNCHES == before + 1
    Ar, Apr = ref.bernstein_featurize_ref(Y, bounds, degree)
    torch.testing.assert_close(A, Ar, rtol=0, atol=1e-6)
    torch.testing.assert_close(Ap, Apr, rtol=0, atol=1e-6)
    with pytest.raises(ValueError):
        ops.bernstein_featurize(Y.double(), bounds.double(), degree)


@pytest.mark.parametrize("n,D,weighted", [(1, 14, False), (777, 14, True), (300, 64, True)])
def test_gram_kernel(dev, n, D, weighted):
    from repro_torch.kernels.gram import ops, ref

    X = torch.randn(n, D, generator=_g(D)).to(dev)
    sw = torch.rand(n, generator=_g(n)).to(dev) if weighted else None
    G = ops.gram_matrix(X, sw)
    Gr = ref.gram_ref(X.double(), None if sw is None else sw.double())
    assert float((G.double() - Gr).abs().max()) <= 1e-5 * float(Gr.abs().max())
    with pytest.raises(ValueError):
        ops.gram_matrix(torch.zeros(4, 65, device=dev))


@pytest.mark.parametrize("rows,m,d,n_valid", [(64, 8, 5, 64), (1030, 130, 7, 517),
                                              (3000, 300, 16, 3000)])
def test_extremes_kernel(dev, rows, m, d, n_valid):
    from repro_torch.kernels.extremes import ops, ref

    P = torch.randn(rows, d, generator=_g(rows)).to(dev)
    P[rows // 2: 2 * (rows // 2)] = P[: rows // 2].clone()  # exact ties
    dirs = torch.randn(m, d, generator=_g(m)).to(dev)
    got = ops.directional_extremes(P, dirs, n_valid)
    exp = ref.directional_extremes_ref(P, dirs, n_valid)
    for g, e in zip(got, exp):
        assert torch.equal(g, e)
    assert int(got[1].max()) < n_valid and int(got[3].max()) < n_valid


@pytest.mark.parametrize("c,r,m,q,moments", [(300, 2, 20, None, False),
                                             (517, 2, 33, 5, True), (129, 1, 0, None, True)])
def test_sweep_kernel(dev, c, r, m, q, moments):
    from repro_torch.kernels.sweep import ops, ref

    D, d, sk = 14, 7, 64
    g = _g(c)
    X, P = torch.rand(c, D, generator=g).to(dev), torch.randn(c * r, d, generator=g).to(dev)
    sw = torch.rand(c, generator=g).to(dev)
    rows = torch.randint(0, sk, (c,), generator=g).int().to(dev)
    signs = (torch.randint(0, 2, (c,), generator=g) * 2 - 1).float().to(dev)
    dirs = torch.randn(m, d, generator=g).to(dev) if m else None
    omega = torch.randn(D, q, generator=g).to(dev) if q else None
    SX = torch.randn(sk, D, generator=g).to(dev)
    mom = (torch.zeros(d, device=dev), torch.zeros(d, d, device=dev)) if moments else None
    got = ops.fused_sweep_update(SX, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                                 n_valid=c - 3, moments=mom)
    exp = ref.fused_sweep_ref(SX, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                              n_valid=c - 3, moments=mom)
    torch.testing.assert_close(got[0], exp[0], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(got[1], exp[1], rtol=1e-6, atol=1e-6)
    if m:
        for a, b in zip(got[2], exp[2]):
            assert torch.equal(a, b)
    if moments:
        e64 = ref.fused_sweep_ref(SX.double(), X.double(), P.double(), sw.double(), rows,
                                  signs.double(), moments=tuple(t.double() for t in mom),
                                  want_z=False)[3]
        for a, b in zip(got[3], e64):
            torch.testing.assert_close(a.double(), b, rtol=1e-6, atol=1e-4)
    with pytest.raises(ValueError, match="float32"):
        ops.fused_sweep_update(SX.double(), X, P, sw, rows, signs)


def test_scoring_on_the_card_matches_the_cpu_path(dev):
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import ScoringEngine
    from repro_torch.data.dgp import generate

    Y = generate("normal_mixture", 2001, seed=1).astype(np.float32)
    cfg, scaler = M.MCTMConfig(J=2), DataScaler.fit(Y)
    for kw in ({}, {"sketch_size": 196}):
        out = [ScoringEngine(cfg, scaler, chunk_size=700, device=where).score(
            Y, method="ridge-lss", generator=_g(0), hull_k=20, **kw) for where in ("cpu", dev)]
        np.testing.assert_allclose(out[1].scores, out[0].scores, rtol=1e-4)
