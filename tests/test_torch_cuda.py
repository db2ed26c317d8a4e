"""The port's CUDA kernels against their plain versions on the card, at
small ragged shapes. Marked ``cuda``: they skip where no CUDA device is
present (run them on the card with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``).
Tolerances are chip_smoke.py's: bernstein atol 1e-6; gram 1e-5 of max|G|
against float64 (all three bodies: D ≤ 64, up to 160 and above), and bit-identical
across calls, streams and the fused accumulator;
extremes exact (same FMA chain on both sides); sweep 1e-6 against the plain
version on the card, and at the default sketch of J = 2, 10 and 20 SX' and
z bit-identical to the plain version on the CPU; moments rtol 1e-6 / atol
1e-4 against the plain version in float64; flash_attention f32 atol 2e-5 and bf16
atol 3e-2 (the reference's own bounds; the kernel rounds the softmax weights
to bf16 for the tensor-core PV product), and bf16 also per element within
``flash_attention.ref.bf16_error_bound`` (the roundings of the output and of
the softmax weights, from the same inputs in f32); ssd 1e-4·max at f32 and 1e-2·max
for a bf16 y (its rounding), the f32 state 1e-4·max, on both bodies, and
bit-identical across calls; the reduced LMs' logits
on the card against the CPU at f32 within 1e-4·max, and their f32 train
steps' losses within 1e-4 relative."""
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


@pytest.mark.parametrize("degree", [0, 6, 15])
@pytest.mark.parametrize("n,J", [(1, 1), (255, 1), (257, 1), (4099, 3)])
def test_bernstein_kernel_ragged_tiles(dev, n, J, degree):
    """Value counts n·J that are no multiple of the 256-value tile: the last
    tile's 16-byte stores stop short and its tail is written by scalars. The
    same bits on repeated calls."""
    from repro_torch.kernels.bernstein import ops, ref

    Y = (torch.randn(n, J, generator=_g(n + degree)) * 3).to(dev)
    bounds = torch.tensor([[-6.0] * J, [6.0] * J, [1 / 12.0] * J], device=dev)
    A, Ap = ops.bernstein_featurize(Y, bounds, degree)
    Ar, Apr = ref.bernstein_featurize_ref(Y, bounds, degree)
    torch.testing.assert_close(A, Ar, rtol=0, atol=1e-6)
    torch.testing.assert_close(Ap, Apr, rtol=0, atol=1e-6)
    for _ in range(3):
        A2, Ap2 = ops.bernstein_featurize(Y, bounds, degree)
        assert torch.equal(A2, A) and torch.equal(Ap2, Ap)


@pytest.mark.parametrize("n,D,weighted", [
    (0, 14, True), (1, 14, False), (777, 14, True), (300, 64, True), (5, 3, True),
    (16_384, 14, True), (16_387, 14, False), (40_000, 37, True), (250_001, 14, True),
    (0, 70, True), (1, 65, False), (16_384, 70, True), (16_384, 140, True), (20_001, 160, False),
    (777, 99, True), (16_384, 15, True), (16_384, 16, True), (250_001, 16, True),
    (40_000, 23, False),
])
def test_gram_kernel(dev, n, D, weighted):
    """n from none to many rows per CTA of a 16-CTA cluster, ragged n, D
    that is no multiple of 4, and the path's (16,384, 14) chunk; the
    conditional path's D = dJ + F (15, 16, 23: J = 2, degree 6, F = 1, 2,
    9); the tiled body for 64 < D ≤ 160 at J = 10 and 20's D = 70 and 140."""
    from repro_torch.kernels.gram import ops, ref

    X = torch.randn(n, D, generator=_g(D)).to(dev)
    sw = torch.rand(n, generator=_g(n)).to(dev) if weighted else None
    before = ops.LAUNCHES
    G = ops.gram_matrix(X, sw)
    assert ops.LAUNCHES == before + 1
    Gr = ref.gram_ref(X.double(), None if sw is None else sw.double())
    assert float((G.double() - Gr).abs().max()) <= 1e-5 * float(Gr.abs().max())
    assert torch.equal(G, G.T)
    # past the tiled body's D the large body takes the call (once a refusal)
    large = ops.PATH_LAUNCHES["large"]
    Z = ops.gram_matrix(torch.zeros(4, ops.TILED_MAX_D + 1, device=dev))
    assert ops.PATH_LAUNCHES["large"] == large + 1 and not bool(Z.any())
    with pytest.raises(ValueError):
        ops.gram_matrix(X.double())


@pytest.mark.parametrize("n,D", [(16_384, 14), (250_001, 14), (1000, 64), (16_384, 140),
                                 (16_384, 15), (16_384, 16)])
def test_gram_kernel_is_bit_identical_across_calls_and_streams(dev, n, D):
    """The fixed-order reduction: the same bits on every call, on the
    default stream and on a second one."""
    from repro_torch.kernels.gram import ops

    X = torch.randn(n, D, generator=_g(n)).to(dev)
    sw = torch.rand(n, generator=_g(D)).to(dev)
    first = ops.gram_matrix(X, sw)
    again = [ops.gram_matrix(X, sw) for _ in range(5)]
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        on_side = [ops.gram_matrix(X, sw) for _ in range(3)]
    torch.cuda.current_stream(dev).wait_stream(side)
    for G in again + on_side:
        assert torch.equal(G, first)


@pytest.mark.parametrize("n,D,weighted", [(0, 14, True), (777, 14, True), (16_384, 14, False),
                                          (300, 64, True), (0, 70, True), (5_000, 140, False)])
def test_gram_kernel_accumulator_equals_the_separate_add(dev, n, D, weighted):
    """gram_matrix(X, sw, acc=G) has the bits of G + gram_matrix(X, sw),
    for an accumulator that is not symmetric."""
    from repro_torch.kernels.gram import ops

    X = torch.randn(n, D, generator=_g(n + 1)).to(dev)
    sw = torch.rand(n, generator=_g(n + 2)).to(dev) if weighted else None
    acc = torch.randn(D, D, generator=_g(D)).to(dev) * 1e3
    before = ops.LAUNCHES
    fused = ops.gram_matrix(X, sw, acc=acc)
    assert ops.LAUNCHES == before + 1
    assert torch.equal(fused, acc + ops.gram_matrix(X, sw))
    with pytest.raises(ValueError, match="acc"):
        ops.gram_matrix(X, sw, acc=acc[:-1])


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [0, 1, 127, 16_384, 20_001, 100_000])
@pytest.mark.parametrize("D", [65, 70, 72, 97, 128, 140, 160])
def test_gram_tiled_body(dev, monkeypatch, D, n, weighted, with_acc):
    """The tiled body (64 < D ≤ 160): D of every copy width (4-, 8- and
    16-byte rows) and of 1 to 10 tiles a warp, n from none to a ragged wave
    of CTAs, and past n ≈ 61,440, where a span's segment sums carry
    compensations while the wave's trailing CTAs are short or empty (every
    rank of a cluster reads every CTA's compensations). Within
    1e-5·max|G| of float64; the same bits on repeated calls and, with acc=,
    those of the separate add; one launch a call, on the tiled body;
    torch.mm and the plain version are never reached."""
    from repro_torch.kernels.gram import ops, ref

    X = torch.randn(n, D, generator=_g(D + n)).to(dev)
    sw = torch.rand(n, generator=_g(n + 1)).to(dev) if weighted else None
    acc = torch.randn(D, D, generator=_g(D)).to(dev) * 1e2 if with_acc else None
    Gr = ref.gram_ref(X.double(), None if sw is None else sw.double(),
                      acc=None if acc is None else acc.double())

    def refuse(*args, **kwargs):
        raise AssertionError("gram_matrix on a CUDA tensor left the kernel")

    monkeypatch.setattr(ops, "gram_ref", refuse)
    monkeypatch.setattr(torch, "mm", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    before, tiled = ops.LAUNCHES, ops.PATH_LAUNCHES["tiled"]
    G = ops.gram_matrix(X, sw, acc=acc)
    assert ops.LAUNCHES == before + 1 and ops.PATH_LAUNCHES["tiled"] == tiled + 1
    again = [ops.gram_matrix(X, sw, acc=acc) for _ in range(3)]
    plain = ops.gram_matrix(X, sw)
    monkeypatch.undo()
    scale = max(float(Gr.abs().max()), 1e-30)
    assert float((G.double() - Gr).abs().max()) <= 1e-5 * scale
    for a in again:
        assert torch.equal(a, G)
    assert torch.equal(G, plain if acc is None else acc + plain)
    assert torch.equal(plain, plain.T)


@pytest.mark.parametrize("D", [65, 70, 72, 80, 81, 96, 97, 112, 113, 128, 129, 140, 144, 145, 160])
def test_gram_tiled_plan_is_the_model(dev, D):
    """The tiled body's plan as ``csrc/gram.cu`` builds it on the host is
    the CPU model's (tests/gram_tiled_plan_model.py, whose coverage of the
    triangle tests/test_torch_kernels_ref.py checks) run for run; D outside
    (64, 160] has none."""
    from gram_tiled_plan_model import tiled_plan_model

    from repro_torch.kernels.gram import ops

    assert ops.tiled_plan(D) == tiled_plan_model(D)
    for bad in (ops.SMALL_MAX_D, ops.TILED_MAX_D + 1):
        with pytest.raises(RuntimeError):
            ops.tiled_plan(bad)


@pytest.mark.parametrize("with_acc", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [0, 1, 1000, 16_387, 70_001])
@pytest.mark.parametrize("D", [161, 256, 2048, 300, 2049])
def test_gram_large_body(dev, monkeypatch, D, n, weighted, with_acc):
    """The large body (D > 160, any D): D past one 128-column tile and
    ragged (161, 300, 2,049; 161 and 2,049 padded by the wrapper to a
    multiple of 4 columns), n from none to many row
    splits with a ragged last stage. Within
    1e-5·max|G| of float64; the same bits on repeated calls and, with acc=,
    those of the separate add; one wrapper launch a call, on the large body;
    torch.mm and the plain version are never reached."""
    from repro_torch.kernels.gram import ops, ref

    X = torch.randn(n, D, generator=_g(D + n)).to(dev)
    sw = torch.rand(n, generator=_g(n + 1)).to(dev) if weighted else None
    acc = torch.randn(D, D, generator=_g(D)).to(dev) * 1e2 if with_acc else None
    Gr = ref.gram_ref(X.double(), None if sw is None else sw.double(),
                      acc=None if acc is None else acc.double())

    def refuse(*args, **kwargs):
        raise AssertionError("gram_matrix on a CUDA tensor left the kernel")

    monkeypatch.setattr(ops, "gram_ref", refuse)
    monkeypatch.setattr(torch, "mm", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    before, large = ops.LAUNCHES, ops.PATH_LAUNCHES["large"]
    G = ops.gram_matrix(X, sw, acc=acc)
    assert ops.LAUNCHES == before + 1 and ops.PATH_LAUNCHES["large"] == large + 1
    again = [ops.gram_matrix(X, sw, acc=acc) for _ in range(2)]
    plain = ops.gram_matrix(X, sw)
    monkeypatch.undo()
    scale = max(float(Gr.abs().max()), 1e-30)
    assert float((G.double() - Gr).abs().max()) <= 1e-5 * scale
    for a in again:
        assert torch.equal(a, G)
    assert torch.equal(G, plain if acc is None else acc + plain)
    assert torch.equal(plain, plain.T)


@pytest.mark.parametrize("D", [70, 97, 140])
def test_gram_tiled_body_ignores_stale_shared_memory(dev, D):
    """A call over NaN rows and weights leaves NaN in every SM's shared
    memory; the next weighted call with a ragged last stage (n = 20,001)
    must not read it: the rows past a span carry √w = 0 and zero values."""
    from repro_torch.kernels.gram import ops, ref

    nan_X = torch.full((16_384, D), float("nan"), device=dev)
    nan_w = torch.full((16_384,), float("nan"), device=dev)
    X = torch.randn(20_001, D, generator=_g(D)).to(dev)
    sw = torch.rand(20_001, generator=_g(D + 1)).to(dev)
    Gr = ref.gram_ref(X.double(), sw.double())
    for _ in range(3):
        ops.gram_matrix(nan_X, nan_w)
        G = ops.gram_matrix(X, sw)
        assert bool(torch.isfinite(G).all())
        assert float((G.double() - Gr).abs().max()) <= 1e-5 * float(Gr.abs().max())


@pytest.mark.parametrize("rows,m,d,n_valid", [(64, 8, 5, 64), (1030, 130, 7, 517),
                                              (3000, 300, 16, 3000), (1030, 1, 16, 517),
                                              (32_768, 1, 7, 32_768), (500_002, 1, 7, 500_002)])
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


@pytest.mark.parametrize("d", [17, 33, 70, 140, 1024, 4096])
@pytest.mark.parametrize("rows,m,valid", [(3001, 130, 3001), (3001, 130, 2900), (700, 1, 513),
                                          (3001, 8, 2999), (5003, 1614, 4711)])
def test_extremes_wide_body(dev, d, rows, m, valid):
    """The wide body (d > 16): values to the bit (±0 included) and
    first-occurrence indices of the plain version, exact ties in the second
    half, ragged validity, one direction as the greedy hull walk asks; every
    tile of ``wide_launch_plan`` (m = 1: a lane a row; 8, 130 and 1,614:
    128 directions × 128 rows), several row blocks; the same
    bits on a repeated call; the wide body counted, the template not."""
    from repro_torch.kernels.extremes import ops, ref

    P = torch.randn(rows, d, generator=_g(rows + d)).to(dev)
    P[rows // 2: 2 * (rows // 2)] = P[: rows // 2].clone()
    dirs = torch.randn(m, d, generator=_g(m + d)).to(dev)
    before = dict(ops.PATH_LAUNCHES)
    got = ops.directional_extremes(P, dirs, valid)
    assert ops.PATH_LAUNCHES["wide"] == before["wide"] + 1
    assert ops.PATH_LAUNCHES["template"] == before["template"]
    exp = ref.directional_extremes_ref(P, dirs, valid)
    for g, e in zip(got, exp):
        assert _same_bits(g, e)
    ids = torch.cat([got[1], got[3]])  # a copied row never beats its original
    assert bool(((ids < rows // 2) | (ids >= 2 * (rows // 2))).all()) and int(ids.max()) < valid
    again = ops.directional_extremes(P, dirs, valid)
    assert all(_same_bits(a, b) for a, b in zip(again, got))


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


def _device_kernels(fn, calls=4, tries=5):
    """Device kernels launched per call of ``fn`` (torch.profiler). A window
    with no kernel, or a count that is no multiple of ``calls``, lost kernel
    records (the profiler drops some late in a long run, as
    chip_smoke.clean_window finds), so it is taken again, up to ``tries``
    times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        n = sum(e.device_type == DeviceType.CUDA for e in prof.events())
        if n and n % calls == 0:
            break
    return n / calls


def _same_bits(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32).cpu(), b.view(torch.int32).cpu())


@pytest.mark.parametrize("n_valid", [32_768, 32_768 - 1001])
def test_extremes_kernel_at_the_path_shape(dev, n_valid):
    """(32,768 × 7) × 1,614, the second half a copy of the first: values
    (to the bit, ±0 included) and first-occurrence indices of the plain
    version; the same bits on repeated calls; two device kernels a call."""
    from repro_torch.kernels.extremes import ops, ref

    P = torch.randn(32_768, 7, generator=_g(7)).to(dev)
    P[16_384:] = P[:16_384].clone()
    dirs = torch.randn(1614, 7, generator=_g(8)).to(dev)
    got = ops.directional_extremes(P, dirs, n_valid)
    exp = ref.directional_extremes_ref(P, dirs, n_valid)
    for g, e in zip(got, exp):
        assert _same_bits(g, e)
    if n_valid == 32_768:
        assert int(got[1].max()) < 16_384 and int(got[3].max()) < 16_384
    for _ in range(3):
        assert all(torch.equal(a, b) for a, b in zip(ops.directional_extremes(P, dirs, n_valid),
                                                     got))
    assert _device_kernels(lambda: ops.directional_extremes(P, dirs, n_valid)) == 2


def _sweep_inputs(J, c, sk, m, q, seed):
    g = _g(seed)
    D, d = 7 * J, 7
    X, P = torch.rand(c, D, generator=g), torch.randn(c * J, d, generator=g)
    sw = torch.rand(c, generator=g)
    sw[-5:] = 0.0  # padding rows
    rows = torch.randint(0, sk, (c,), generator=g).int()
    signs = (torch.randint(0, 2, (c,), generator=g) * 2 - 1).float()
    dirs = torch.randn(m, d, generator=g) if m else None
    omega = torch.randn(D, q, generator=g) if q else None
    SX = torch.randn(sk, D, generator=g)
    mom = (torch.randn(d, generator=g), torch.randn(d, d, generator=g) * 100)
    return SX, X, P, sw, rows, signs, dirs, omega, mom


@pytest.mark.parametrize("J,m,q", [(2, 1614, None), (2, 1614, 8), (10, 200, None), (20, 200, 16)])
def test_sweep_kernel_at_the_default_sketch(dev, J, m, q):
    """One 16,384-point chunk at the default one-pass sketch 4·(7J)² (784,
    19,600, 78,400): SX' and z have the bits of the plain version on the
    CPU (each bucket's points added in ascending order from the carry;
    z's FMA chain), the extremes those of the plain version's dense
    argmax, the moments are within rtol 1e-6 / atol 1e-4 of float64, and
    repeated calls give the same bits; two device kernels a call."""
    from repro_torch.kernels.sweep import ops, ref

    c = 16_384
    sk = 4 * (7 * J) ** 2
    cpu = _sweep_inputs(J, c, sk, m, q, J + m)
    SX, X, P, sw, rows, signs, dirs, omega = (None if t is None else t.to(dev) for t in cpu[:8])
    mom = tuple(t.to(dev) for t in cpu[8])
    nv = c - 77
    got = ops.fused_sweep_update(SX, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                                 n_valid=nv, moments=mom)
    SXc, Xc, Pc, swc, rowsc, signsc, _, omc, _ = cpu
    exp = ref.fused_sweep_ref(SXc, Xc, Pc, swc, rowsc, signsc, omega=omc)
    assert _same_bits(got[0], exp[0]) and _same_bits(got[1], exp[1])
    ext = ref.fused_sweep_ref(SX, X, P, sw, rows, signs, dirs=dirs, n_valid=nv, want_z=False)[2]
    for a, b in zip(got[2], ext):
        assert _same_bits(a, b)
    e64 = ref.fused_sweep_ref(SX.double(), X.double(), P.double(), sw.double(), rows,
                              signs.double(), moments=tuple(t.double() for t in mom),
                              want_z=False)[3]
    for a, b in zip(got[3], e64):
        torch.testing.assert_close(a.double(), b, rtol=1e-6, atol=1e-4)
    again = ops.fused_sweep_update(SX, X, P, sw, rows, signs, dirs=dirs, omega=omega,
                                   n_valid=nv, moments=mom)
    for a, b in zip((again[0], again[1], *again[2], *again[3]),
                    (got[0], got[1], *got[2], *got[3])):
        assert torch.equal(a, b)
    assert _device_kernels(lambda: ops.fused_sweep_update(
        SX, X, P, sw, rows, signs, dirs=dirs, omega=omega, n_valid=nv, moments=mom)) == 2
    with pytest.raises(ValueError, match="Σp"):  # the kernel reads the carry as float32
        ops.fused_sweep_update(SX, X, P, sw, rows, signs, moments=(mom[0].double(), mom[1]))
    # the two-pass-sketched pass-1 call (no dirs, no z) and z alone
    assert _device_kernels(lambda: ops.fused_sweep_update(
        SX, X, P, sw, rows, signs, moments=mom, want_z=False)) == 2
    assert _device_kernels(lambda: ops.fused_sweep_update(SX, X, None, sw, rows, signs)) == 1


@pytest.mark.parametrize("m", [0, 1614])
def test_sweep_kernel_at_the_conditional_width(dev, m):
    """The conditional one-pass chunk: rows (b_i, x_i) of D = 16 (J = 2,
    degree 6, F = 2), r = 2 P rows a point, sketch 4·D² = 1,024: SX' and z
    have the bits of the plain version on the CPU, the extremes those of the
    plain version on the card, the moments within rtol 1e-6 / atol 1e-4 of
    float64; the same bits on a repeated call."""
    from repro_torch.kernels.sweep import ops, ref

    c, D, d, sk = 16_384, 16, 7, 1024
    g = _g(16 + m)
    Xc = torch.cat([torch.rand(c, 14, generator=g), torch.randn(c, 2, generator=g)], dim=1)
    Pc = torch.randn(2 * c, d, generator=g)
    swc = torch.ones(c)
    rowsc = torch.randint(0, sk, (c,), generator=g).int()
    signsc = (torch.randint(0, 2, (c,), generator=g) * 2 - 1).float()
    SXc = torch.randn(sk, D, generator=g)
    dirs = torch.randn(m, d, generator=g).to(dev) if m else None
    mom = (torch.zeros(d, device=dev), torch.zeros(d, d, device=dev))
    SX, X, P, sw, rows, signs = (t.to(dev) for t in (SXc, Xc, Pc, swc, rowsc, signsc))
    got = ops.fused_sweep_update(SX, X, P, sw, rows, signs, dirs=dirs, moments=mom)
    exp = ref.fused_sweep_ref(SXc, Xc, Pc, swc, rowsc, signsc)
    assert _same_bits(got[0], exp[0]) and _same_bits(got[1], exp[1])
    if m:
        ext = ref.fused_sweep_ref(SX, X, P, sw, rows, signs, dirs=dirs, want_z=False)[2]
        for a, b in zip(got[2], ext):
            assert _same_bits(a, b)
    e64 = ref.fused_sweep_ref(SX.double(), X.double(), P.double(), sw.double(), rows,
                              signs.double(), moments=tuple(t.double() for t in mom),
                              want_z=False)[3]
    for a, b in zip(got[3], e64):
        torch.testing.assert_close(a.double(), b, rtol=1e-6, atol=1e-4)
    again = ops.fused_sweep_update(SX, X, P, sw, rows, signs, dirs=dirs, moments=mom)
    for a, b in zip((again[0], again[1], *(again[2] or ()), *again[3]),
                    (got[0], got[1], *(got[2] or ()), *got[3])):
        assert torch.equal(a, b)


def test_float64_countsketch_gives_the_same_bits(dev):
    """``scoring.countsketch_add`` (float64) on the card: the bits of the CPU's
    (the same float64 additions in the same order), on every call; and the
    sketched strategies with ``gram_dtype="float64"`` give the same scores
    on repeated calls."""
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import ScoringEngine, countsketch_add
    from repro_torch.data.dgp import generate

    g = _g(64)
    SX = torch.randn(1024, 16, generator=g, dtype=torch.float64)
    V = torch.randn(16_384, 16, generator=g) * torch.logspace(-5, 2, 16_384)[:, None]
    rows = torch.randint(0, 1024, (16_384,), generator=g)
    want = countsketch_add(SX, V, rows)
    for _ in range(3):
        assert torch.equal(countsketch_add(SX.to(dev), V.to(dev), rows.to(dev)).cpu(), want)
    Y = generate("normal_mixture", 5001, seed=2).astype(np.float32)
    cfg, scaler = M.MCTMConfig(J=2), DataScaler.fit(Y)
    for strategy in ("two-pass-sketched", "one-pass"):
        eng = ScoringEngine(cfg, scaler, chunk_size=2000, gram_dtype="float64", device=dev)
        out = [eng.score(Y, method="l2-hull", generator=_g(1), hull_k=20, sketch_size=196,
                         strategy=strategy) for _ in range(3)]
        assert out[0].gram.dtype == np.float64
        for o in out[1:]:
            np.testing.assert_array_equal(o.scores, out[0].scores)
            np.testing.assert_array_equal(o.gram, out[0].gram)
            np.testing.assert_array_equal(o.hull_rows, out[0].hull_rows)


def _cond_case(n=4000, F=2, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, F))
    beta = rng.standard_normal((2, F))
    Y = X @ beta.T + rng.standard_normal((n, 2)) @ np.linalg.cholesky(
        np.array([[1, 0.6], [0.6, 1]])).T
    return Y.astype(np.float32), X.astype(np.float32)


@pytest.mark.parametrize("sketch", [0, 1024])
def test_conditional_scores_and_build_on_the_card_match_the_cpu_path(dev, sketch):
    """The conditional engine (D = 16) on the card against the CPU path:
    l2 scores within atol 5e-4 (tests/test_torch_conditional.py's), and the
    build on the same plans and draw: the same sampled ids, ≥ 80% of the
    hull points in common (chip_smoke.py's COND_HULL_COMMON_FLOOR: the
    card's bernstein bits move the argmax between near-ties; 35 of 40 here
    on an H100), weights rtol 5e-3."""
    from repro_torch.core import conditional as C
    from repro_torch.core.bernstein import DataScaler

    Y, X = _cond_case()
    cfg, scaler = C.CMCTMConfig(J=2, n_features=2, degree=6), DataScaler.fit(Y)
    kw = dict(chunk_size=1500, sketch_size=sketch)
    plan = None
    if sketch:
        plan = tuple(t.numpy() for t in (torch.randint(0, sketch, (4000,), generator=_g(5)),
                                         torch.randint(0, 2, (4000,), generator=_g(6)) * 2. - 1))
    s = [C.conditional_coreset_scores(cfg, scaler, Y, X, plan=plan, device=where, **kw)
         for where in ("cpu", dev)]
    np.testing.assert_allclose(s[1], s[0], rtol=0, atol=5e-4)
    k, k1 = 200, 160
    draw = torch.randint(0, 4000, (k1,), generator=_g(7)).numpy()
    normals = torch.randn(4 * (k - k1), 7, generator=_g(8)).numpy()
    out = [C.build_conditional_coreset(cfg, scaler, Y, X, k, plan=plan, hull_normals=normals,
                                       draw=draw, device=where, **kw) for where in ("cpu", dev)]
    (ic, wc), (ig, wg) = out
    assert ig.shape == (k,) and len(set(ig[k1:].tolist())) == k - k1
    np.testing.assert_array_equal(ig[:k1], ic[:k1])
    assert np.intersect1d(ig[k1:], ic[k1:]).size >= 0.8 * (k - k1)
    np.testing.assert_allclose(wg, wc, rtol=5e-3)


def test_hull_api_on_the_card_matches_its_plain_version(dev, monkeypatch):
    """greedy_hull_projection and epsilon_kernel_indices on the extremes
    kernel against the same functions on the kernel's plain version, both
    on the card: the same support and ids, t within 1e-6, at d = 7 (the
    template body) and d = 70 (the wide body)."""
    from repro_torch.core import hull as H
    from repro_torch.kernels.extremes.ref import directional_extremes_ref

    rng = np.random.default_rng(3)
    for dim in (7, 70):
        P = (rng.standard_normal((20_000, dim)) * rng.uniform(0.5, 2, dim)).astype(np.float32)
        normals = rng.standard_normal((160, dim)).astype(np.float32)
        q_out = P.max(0) * 1.5
        kernel = [H.greedy_hull_projection(P, q, 1e-2, 64, device=dev)
                  for q in (P.mean(0), q_out)]
        ids = H.epsilon_kernel_indices(P, 40, normals=normals, device=dev)
        with monkeypatch.context() as mp:
            mp.setattr(H, "directional_extremes", directional_extremes_ref)
            plain = [H.greedy_hull_projection(P, q, 1e-2, 64, device=dev)
                     for q in (P.mean(0), q_out)]
            plain_ids = H.epsilon_kernel_indices(P, 40, normals=normals, device=dev)
        for (t, s, d), (tp, sp, dp) in zip(kernel, plain):
            assert torch.equal(s, sp)
            assert float((t - tp).abs().max()) <= 1e-6 and float((d - dp).abs().max()) <= 1e-6
        np.testing.assert_array_equal(ids, plain_ids)
        if dim == 7:
            assert H.hull_distance(P, P.mean(0), device=dev) < 1e-2


def test_leverage_and_sample_on_the_card(dev):
    """The standalone leverage API on the card against float64 of the same
    X (the gram kernel's float32 Gram: ridge rtol 1e-4; the l2 forms atol
    2e-3, the ill-conditioned degree-6 pseudo-inverse); the CountSketch
    estimate on the sweep kernel against float64 of the same plan and
    against the CPU's within atol 5e-3 (the sweep gives the CPU's SX bits,
    and the float32 products SXᵀSX on the two devices move the
    pseudo-inverse by up to 3.6e-3 here on an H100); at D = 161, past one
    160-column slab of the sweep's sketch CTAs, the sweep gives the CPU's SX
    bits too, so the well-conditioned Gaussian case agrees to rtol 1e-4;
    ``sample`` on the CPU's normals within 1e-4 of the scaler's span of the
    CPU's."""
    from repro_torch.core import leverage as L
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import _mctm_featurize
    from repro_torch.data.dgp import generate

    Y = generate("normal_mixture", 20_001, seed=3).astype(np.float32)
    cfg, scaler = M.MCTMConfig(J=2), DataScaler.fit(Y)
    X = _mctm_featurize(cfg, scaler)(torch.as_tensor(Y, device=dev))[0]
    X64 = X.double()
    ridge = L.ridge_leverage_scores(X, device=dev)
    torch.testing.assert_close(ridge.double(), L.ridge_leverage_scores(X64, device=dev),
                               rtol=1e-4, atol=0)
    for fn in (L.leverage_scores_gram, L.root_leverage_scores):
        torch.testing.assert_close(fn(X, device=dev).double(), fn(X64, device=dev),
                                   rtol=0, atol=2e-3)
    plan = (torch.randint(0, 784, (20_001,), generator=_g(1)),
            torch.randint(0, 2, (20_001,), generator=_g(2)) * 2.0 - 1)
    a = L.sketched_leverage(X, 784, plan=plan, chunk_size=8192, device=dev)
    b = L.sketched_leverage(X.cpu(), 784, plan=plan, chunk_size=8192, device="cpu")
    a64 = L.sketched_leverage(X64, 784, plan=plan, chunk_size=8192, device=dev)
    torch.testing.assert_close(a.double(), a64, rtol=0, atol=5e-3)
    torch.testing.assert_close(a.cpu(), b, rtol=0, atol=5e-3)
    Xg = torch.randn(3000, 161, generator=_g(6))
    plan = (torch.randint(0, 2000, (3000,), generator=_g(7)),
            torch.randint(0, 2, (3000,), generator=_g(8)) * 2.0 - 1)
    a = L.sketched_leverage(Xg.to(dev), 2000, plan=plan, chunk_size=1024, device=dev)
    b = L.sketched_leverage(Xg, 2000, plan=plan, chunk_size=1024, device="cpu")
    torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-7)
    params = M.init_params(cfg, generator=_g(4), device="cpu")
    normals = torch.randn(20_001, 2, generator=_g(5))
    got = M.sample(cfg, M.params_from_numpy(*M.params_to_numpy(params), device=dev), scaler,
                   20_001, normals=normals, device=dev).cpu()
    want = M.sample(cfg, params, scaler, 20_001, normals=normals, device="cpu")
    span = torch.as_tensor(scaler.high - scaler.low, dtype=torch.float32)
    assert float(((got - want) / span).abs().max()) <= 1e-4
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("D", [14, 2048])
def test_sweep_kernel_with_every_point_in_one_bucket(dev, D):
    """All points in bucket 3 of 784: at D = 14 (16,384 points) one sketch CTA
    flushes its range in parts; at D = 2,048 (4,096 points) one range's
    tiles take every point of every partition unit. SX' (and z past D =
    160) keep the plain version's bits, and a repeated call its own."""
    from repro_torch.kernels.sweep import ops, ref

    if D == 14:
        SX, X, P, sw, rows, signs, _, _, _ = _sweep_inputs(2, 16_384, 784, 0, None, 3)
    else:
        g = _g(D)
        X, sw = torch.rand(4096, D, generator=g), torch.rand(4096, generator=g)
        signs = (torch.randint(0, 2, (4096,), generator=g) * 2 - 1).float()
        SX, rows = torch.randn(784, D, generator=g), torch.zeros(4096, dtype=torch.int32)
    rows[:] = 3
    want_z = D > 160
    wide = ops.PATH_LAUNCHES["wide"]
    got = ops.fused_sweep_update(SX.to(dev), X.to(dev), None, sw.to(dev), rows.to(dev),
                                 signs.to(dev), want_z=want_z)
    exp = ref.fused_sweep_ref(SX, X, None, sw, rows, signs, want_z=want_z)
    assert _same_bits(got[0], exp[0])
    assert not want_z or _same_bits(got[1], exp[1])
    again = ops.fused_sweep_update(SX.to(dev), X.to(dev), None, sw.to(dev), rows.to(dev),
                                   signs.to(dev), want_z=want_z)
    assert _same_bits(again[0], got[0])
    assert ops.PATH_LAUNCHES["wide"] - wide == (2 if want_z else 0)


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


def test_scoring_on_the_card_matches_the_cpu_path_at_j10(dev):
    """J = 10 (D = 70) on covertype, both strategies (one-pass at its default
    sketch 4·D² = 19,600): ridge-lss scores to rtol 2e-5 and ≥ 90% of the
    hull points in common with the port's CPU path (test_torch_scoring.py's
    tolerances)."""
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import ScoringEngine
    from repro_torch.data import generate_covertype

    Y = generate_covertype(3001, seed=0).astype(np.float32)
    cfg, scaler = M.MCTMConfig(J=10, degree=6), DataScaler.fit(Y)
    for kw in ({}, {"sketch_size": 4 * 70 * 70}):
        out = [ScoringEngine(cfg, scaler, chunk_size=1000, device=where).score(
            Y, method="ridge-lss", generator=_g(0), hull_k=30, **kw) for where in ("cpu", dev)]
        np.testing.assert_allclose(out[1].scores, out[0].scores, rtol=2e-5)
        common = np.intersect1d(out[1].hull_points, out[0].hull_points).size
        assert common >= 0.9 * out[0].hull_points.size


# the wgmma body (bf16, d ∈ {64, 128}) at GQA ratios H/KV ∈ {1, 4, 8} and S
# around its 128-row tiles (small grids split the heaviest q tiles' key
# ranges), then the mma.sync (d ∈ {16, 32}) and f32-FMA bodies
_FA_CASES = [
    (2 if S == 777 else 1, S, 2 * ratio, 2, d, "bfloat16")
    for d in (64, 128) for ratio in (1, 4, 8) for S in (1, 63, 64, 65, 777, 1024, 2048)
] + [
    (1, 130, 4, 4, 16, "bfloat16"), (2, 257, 4, 2, 32, "bfloat16"), (1, 64, 2, 1, 48, "bfloat16"),
    (1, 100, 4, 2, 8, "float32"), (2, 257, 4, 2, 128, "float32"),
] + [
    # d = 256: the wgmma body's 64-key tiles around its 128-row q tiles, at
    # GQA ratio 1 and recurrentgemma's 10 heads on one KV head
    (2 if S == 777 else 1, S, H, KV, 256, "bfloat16")
    for H, KV in ((2, 2), (10, 1)) for S in (1, 63, 64, 65, 129, 777, 1024)
] + [
    # past d = 128 on the f32-FMA body (four threads a row, 16-key tiles)
    (B, S, H, KV, d, dtype) for d in (160, 256) for dtype in ("bfloat16", "float32")
    if (d, dtype) != (256, "bfloat16") for B, S, H, KV in ((1, 1, 2, 1), (2, 130, 4, 2), (1, 257, 10, 1))
] + [
    # the served shapes no earlier case covers: phi-3-vision's bf16 d = 96
    # on the wgmma body (its prefill of 256 patches and 1,024 tokens),
    # whisper-medium's encoder on the wgmma body at d = 64 over 1,500
    # frames at the served batch of 4, gemma-2b's 8 heads on one KV head
    (1, S, 32, 32, 96, "bfloat16") for S in (1, 65, 1280)
] + [(4, 1500, 16, 16, 64, "bfloat16")] + [
    (1, S, 8, 1, 256, "bfloat16") for S in (65, 1024)
] + [
    # d = 96 on the wgmma body (two 64-column chunks, the second zero-filled
    # past 96) around its 128-row tiles, at GQA ratios 1 and 4
    (1, S, 2 * ratio, 2, 96, "bfloat16") for ratio in (1, 4) for S in (1, 63, 64, 65, 129, 1280)
]


@pytest.mark.parametrize("B,S,H,KV,d,dtype", _FA_CASES)
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_kernel(dev, B, S, H, KV, d, dtype, causal):
    from repro_torch.kernels.flash_attention import ops, ref

    g = _g(S + d)
    # q, k, v as views of one fused projection: the kernel reads them by strides
    qkv = torch.randn(B, S, H + 2 * KV, d, generator=g).to(dev, getattr(torch, dtype))
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    path = ops.kernel_path(q)
    assert path == {64: "wgmma", 96: "wgmma", 128: "wgmma", 256: "wgmma", 16: "mma",
                    32: "mma"}.get(d if dtype == "bfloat16" else 0, "simt")
    before, before_path = ops.LAUNCHES, ops.PATH_LAUNCHES[path]
    out = ops.flash_attention(q, k, v, causal=causal)
    assert ops.LAUNCHES == before + 1 and ops.PATH_LAUNCHES[path] == before_path + 1
    assert out.dtype == q.dtype and out.is_contiguous()
    exp = ref.flash_attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(out.float(), exp.float(), rtol=0,
                               atol=3e-2 if dtype == "bfloat16" else 2e-5)
    if dtype == "bfloat16":
        # per element against the f32 output on the same bf16 inputs
        o, bound = ref.bf16_error_bound(q, k, v, causal=causal)
        assert bool(((out.float() - o).abs() <= bound).all())


@pytest.mark.parametrize("d", [64, 96, 128, 256])
def test_flash_attention_copies_misaligned_bf16_rows(dev, d):
    """A bf16 input off the 16-byte grid runs the same tensor-core body on
    an aligned copy: the same bits as the aligned input."""
    from repro_torch.kernels.flash_attention import ops

    B, S, H, KV = 1, 150, 4, 2
    n = B * S * (H + 2 * KV) * d
    flat = torch.randn(n + 1, generator=_g(1)).to(dev, torch.bfloat16)
    odd = flat[1:].view(B, S, H + 2 * KV, d)  # base 2 bytes off the grid
    even = odd.clone()
    assert odd.data_ptr() % 16 and ops.kernel_path(odd) == "wgmma"
    outs = [ops.flash_attention(t[:, :, :H], t[:, :, H:H + KV], t[:, :, H + KV:])
            for t in (odd, even)]
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_d96_reads_and_writes_its_own_columns(dev, causal):
    """At d = 96 the wgmma body pads to 128 columns in shared memory only:
    q, k and v whose next head in memory is NaN give a finite output within
    the bound (TMA reads no column past 96), and an output whose last row
    is followed by sentinels leaves them alone (the store, and the merge of
    a split q tile's parts, write columns < 96 only)."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import ops, ref

    B, S, H, KV, d = 1, 1280, 4, 1, 96
    buf = torch.randn(B, S, 2 * (H + 2 * KV), d, generator=_g(96)).to(dev, torch.bfloat16)
    buf[:, :, 1::2] = float("nan")  # every head's neighbour in memory
    q, k, v = buf[:, :, 0:2 * H:2], buf[:, :, 2 * H:2 * H + 2 * KV:2], buf[:, :, 2 * H + 2 * KV::2]
    assert ops.kernel_path(q) == "wgmma"
    out = ops.flash_attention(q, k, v, causal=causal)
    assert bool(torch.isfinite(out).all())
    qc, kc, vc = (t.contiguous() for t in (q, k, v))
    o, bound = ref.bf16_error_bound(qc, kc, vc, causal=causal)
    assert bool(((out.float() - o).abs() <= bound).all())
    torch.testing.assert_close(out.float(), o, rtol=0, atol=3e-2)

    sentinel = -7.0
    flat = torch.full((out.numel() + 64,), sentinel, dtype=torch.bfloat16, device=dev)
    dst = flat[:out.numel()].view(out.shape)
    cap, slots = ops.split_plan(S, B * H, d, causal, _lib.sm_count(dev.index or 0))
    assert slots  # 40 CTAs split: the merge of a q tile's two parts writes too
    work = torch.empty(slots * ops.ROWS * (d + ops._C["kPartPad"] + 2), dtype=torch.float32,
                       device=dev)
    stream = _lib.stream_ptr(dev)
    _lib.check(_lib.lib().repro_flash_attention(
        qc.data_ptr(), kc.data_ptr(), vc.data_ptr(), dst.data_ptr(), 1, 2, B, S, H, KV, d,
        *qc.stride()[:3], *kc.stride()[:3], *vc.stride()[:3], int(causal), d ** -0.5, cap,
        work.data_ptr(), slots, ops._tickets(dev, stream, 2 * slots).data_ptr(), stream),
        "repro_flash_attention")
    torch.cuda.synchronize()
    assert bool((flat[out.numel():] == sentinel).all())
    assert torch.equal(dst, out)


@pytest.mark.parametrize("S,H,KV,d,causal,split", [
    (1024, 8, 1, 256, True, True), (1024, 8, 1, 256, False, True),
    (1024, 10, 1, 256, True, True), (1024, 10, 1, 256, False, False),
    (1280, 2, 2, 96, True, True), (1280, 2, 2, 96, False, True),
    (1024, 2, 2, 64, True, True), (1024, 2, 2, 64, False, True),
])
def test_flash_attention_split_grid_is_bit_identical(dev, S, H, KV, d, causal, split):
    """gemma-2b's and recurrentgemma's d = 256 prefill (and small grids at
    d = 96 and 64) split the heaviest q tiles where the unsplit grid leaves
    SMs idle (on the H100's 132 SMs as listed; another card by its plan);
    the part of a q tile to finish second merges the two in part order, so
    two calls give the same bits, within the bound of the plain version."""
    from repro_torch.kernels import _lib
    from repro_torch.kernels.flash_attention import ops, ref

    qkv = torch.randn(1, S, H + 2 * KV, d, generator=_g(S + H)).to(dev, torch.bfloat16)
    q, k, v = qkv[:, :, :H], qkv[:, :, H:H + KV], qkv[:, :, H + KV:]
    if _lib.sm_count(dev.index or 0) != 132:
        split = ops.split_plan(S, H, d, causal, _lib.sm_count(dev.index or 0))[1] > 0
    before = ops.SPLIT_LAUNCHES
    outs = [ops.flash_attention(q, k, v, causal=causal) for _ in range(2)]
    assert ops.SPLIT_LAUNCHES == before + 2 * split
    assert torch.equal(outs[0], outs[1])
    o, bound = ref.bf16_error_bound(q, k, v, causal=causal)
    assert bool(((outs[0].float() - o).abs() <= bound).all())


@pytest.mark.parametrize("B,T,H,P,N,chunk,dtype,with_state", [
    (1, 1024, 4, 64, 128, 256, "bfloat16", True), (2, 100, 3, 16, 8, 32, "float32", True),
    (1, 31, 2, 24, 16, 32, "float32", False), (1, 777, 2, 64, 128, 256, "float32", True),
    (1, 5, 2, 32, 16, 5, "float32", True),
    # the mma body: one chunk (the row-block split alone fills the grid), the
    # full serve shape, B = 2 with ragged T, P = 32 with a ragged chunk;
    # grids under one CTA per SM take warp pairs, larger ones single warps
    (1, 256, 32, 64, 128, 256, "bfloat16", True), (1, 1024, 32, 64, 128, 256, "bfloat16", True),
    (2, 1000, 4, 64, 128, 256, "bfloat16", True), (1, 777, 4, 64, 128, 256, "bfloat16", False),
    (1, 100, 2, 32, 32, 64, "bfloat16", True), (2, 1000, 32, 32, 64, 128, "bfloat16", True),
])
def test_ssd_kernel(dev, B, T, H, P, N, chunk, dtype, with_state):
    from repro_torch.kernels.ssd import ops, ref

    g = _g(T + P)
    dt_ = getattr(torch, dtype)
    # x, B and C as views of one conv output, as the model hands them over
    xbc = torch.randn(B, T, H * P + 2 * N, generator=g).to(dev, dt_)
    x = xbc[..., :H * P].reshape(B, T, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, T, 1, N)
    Cm = xbc[..., H * P + N:].reshape(B, T, 1, N)
    dt = (torch.rand(B, T, H, generator=g) * 0.1 + 0.005).to(dev)
    A = -torch.exp(torch.linspace(0.0, np.log(16.0), H)).to(dev)
    s0 = torch.randn(B, H, P, N, generator=g).to(dev) if with_state else None
    before = ops.LAUNCHES
    y, st = ops.ssd_chunked(x, dt, A, Bm, Cm, s0, chunk=chunk)
    assert ops.LAUNCHES == before + 1 and y.dtype == x.dtype and st.dtype == torch.float32
    yr, sr = ref.ssd_chunked_ref(x, dt, A, Bm, Cm, s0, chunk=chunk)
    ytol = (1e-2 if dtype == "bfloat16" else 1e-4) * float(yr.float().abs().max())
    torch.testing.assert_close(y.float(), yr.float(), rtol=0, atol=ytol)
    torch.testing.assert_close(st, sr, rtol=0, atol=1e-4 * float(sr.abs().max()))


def _ssd_args(dev, B, T, H, P, N, dtype, seed):
    g = _g(seed)
    xbc = torch.randn(B, T, H * P + 2 * N, generator=g).to(dev, dtype)
    x = xbc[..., :H * P].reshape(B, T, H, P)
    Bm = xbc[..., H * P:H * P + N].reshape(B, T, 1, N)
    Cm = xbc[..., H * P + N:].reshape(B, T, 1, N)
    dt = (torch.rand(B, T, H, generator=g) * 0.1 + 0.005).to(dev)
    A = -torch.exp(torch.linspace(0.0, np.log(16.0), H)).to(dev)
    s0 = torch.randn(B, H, P, N, generator=g).to(dev)
    return x, dt, A, Bm, Cm, s0


@pytest.mark.parametrize("dtype,P,N,path", [
    ("bfloat16", 64, 128, "mma"), ("bfloat16", 32, 16, "mma"), ("bfloat16", 16, 16, "simt"),
    ("bfloat16", 64, 24, "simt"), ("float32", 64, 128, "simt"),
])
def test_ssd_body_counter(dev, dtype, P, N, path):
    """bf16 calls with P ∈ {32, 64} and N a multiple of 16 take the
    tensor-core body; PATH_LAUNCHES counts each body beside LAUNCHES."""
    from repro_torch.kernels.ssd import ops

    args = _ssd_args(dev, 1, 300, 2, P, N, getattr(torch, dtype), P + N)
    assert ops.kernel_path(args[0], N) == path
    before, paths = ops.LAUNCHES, dict(ops.PATH_LAUNCHES)
    ops.ssd_chunked(*args, chunk=256)
    assert ops.LAUNCHES == before + 1
    assert ops.PATH_LAUNCHES == {k: v + (k == path) for k, v in paths.items()}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ssd_kernel_is_bit_identical_across_calls(dev, dtype):
    """No atomics: two calls on the same inputs give the same bits."""
    from repro_torch.kernels.ssd import ops

    args = _ssd_args(dev, 2, 600, 4, 64, 128, getattr(torch, dtype), 9)
    y, st = ops.ssd_chunked(*args, chunk=256)
    for _ in range(2):
        y2, st2 = ops.ssd_chunked(*args, chunk=256)
        assert torch.equal(y2, y) and torch.equal(st2, st)


def test_ssd_mma_body_copies_misaligned_rows(dev):
    """An x whose base is not 16-byte aligned is copied before the mma body
    reads it: the same result as from an aligned copy."""
    from repro_torch.kernels.ssd import ops

    x, dt, A, Bm, Cm, s0 = _ssd_args(dev, 1, 300, 2, 64, 32, torch.bfloat16, 4)
    wide = torch.zeros(1, 300, 2 * 64 + 1, dtype=torch.bfloat16, device=dev)
    wide[..., 1:] = x.reshape(1, 300, -1)
    odd = wide[..., 1:].reshape(1, 300, 2, 64)
    assert odd.data_ptr() % 16 and ops.kernel_path(odd, 32) == "mma"
    outs = [ops.ssd_chunked(t, dt, A, Bm, Cm, s0, chunk=256) for t in (odd, x.contiguous())]
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("name", ["tinyllama_1b", "mamba2_370m"])
def test_reduced_lm_on_the_card_matches_the_cpu_path(dev, name):
    from repro_torch.configs import get_reduced_config
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.models import build_model

    cfg = get_reduced_config(name).replace(dtype="float32")
    cpu = build_model(cfg, device="cpu", seed=3)
    card = build_model(cfg, device="cpu", seed=3).to(dev)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    before = fa.LAUNCHES + ssd.LAUNCHES
    outs = []
    for model in (cpu, card):
        cache = model.init_cache(2, 48)
        logits, cache = model.prefill({"tokens": tokens}, cache)
        seq = [logits.float().cpu()]
        for _ in range(3):
            nxt = seq[-1][:, -1].argmax(-1, keepdim=True).numpy()
            logits, cache = model.decode_step(nxt, cache)
            seq.append(logits.float().cpu())
        outs.append(torch.cat(seq, 1))
    assert fa.LAUNCHES + ssd.LAUNCHES == before + cfg.n_layers
    torch.testing.assert_close(outs[1], outs[0], rtol=0, atol=1e-4 * float(outs[0].abs().max()))


@pytest.mark.parametrize("which", ["ssd", "flash_attention"])
def test_lm_kernel_wrappers_refuse_inputs_that_require_grad(dev, which):
    """The SSD and flash-attention kernels have no backward: on the CUDA
    route an input that requires grad raises, and no kernel launches (a
    result cut off from the graph would leave the weights upstream without
    gradients)."""
    if which == "ssd":
        from repro_torch.kernels.ssd import ops

        x, dt, A, Bm, Cm, s0 = _ssd_args(dev, 1, 64, 2, 32, 16, torch.float32, 4)
        dt.requires_grad_()
        call = lambda: ops.ssd_chunked(x, dt, A, Bm, Cm, s0, chunk=64)  # noqa: E731
    else:
        from repro_torch.kernels.flash_attention import ops

        q = torch.randn(1, 32, 4, 64, generator=_g(4)).to(dev, torch.bfloat16).requires_grad_()
        k = torch.randn(1, 32, 2, 64, generator=_g(5)).to(dev, torch.bfloat16)
        call = lambda: ops.flash_attention(q, k, k)  # noqa: E731
    before = ops.LAUNCHES
    with pytest.raises(RuntimeError, match="no backward"):
        call()
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("name", ["tinyllama_1b", "mamba2_370m"])
def test_reduced_training_on_the_card_matches_the_cpu_path(dev, name):
    """Three f32 train steps of the reduced LM on the card and on the CPU
    from the same weights and batches: losses within 1e-4 relative, and no
    LM kernel launched (training runs the plain attention and SSD scan)."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.data.synthetic_lm import TokenStreamConfig, sample_batch
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.ssd import ops as ssd
    from repro_torch.models import build_model
    from repro_torch.optim import adamw, chain, clip_by_global_norm, cosine_warmup
    from repro_torch.train import init_train_state, make_train_step

    cfg = get_reduced_config(name).replace(dtype="float32")
    stream = TokenStreamConfig(cfg.vocab_size, 32)
    before = fa.LAUNCHES + ssd.LAUNCHES
    losses = []
    for model in (build_model(cfg, device="cpu", seed=3, train=True),
                  build_model(cfg, device="cpu", seed=3, train=True).to(dev)):
        opt = chain(clip_by_global_norm(1.0), adamw(cosine_warmup(3e-3, 2, 3)))
        state, step = init_train_state(model.param_tree(), opt), make_train_step(model, opt)
        out = []
        for i in range(3):
            state, m = step(state, sample_batch(stream, 4, i))
            out.append(float(m["loss"]))
        losses.append(np.asarray(out))
    assert fa.LAUNCHES + ssd.LAUNCHES == before
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-4, atol=0)


@pytest.mark.parametrize("strategy,kw", [("two-pass", {}), ("one-pass", {"sketch_size": 784})])
def test_resumed_sweep_is_bit_identical_on_the_card(dev, tmp_path, strategy, kw):
    """A sweep on the card crashed in sweep 1 (and, two-pass, in sweep 2),
    resumed from its chunk cursor: the uninterrupted sweep's scores, Gram
    and hull rows to the bit, and the plans' generator where the
    uninterrupted call leaves it."""
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.scoring import ScoringEngine
    from repro_torch.data.dgp import generate
    from repro_torch.ft import FailureSimulator, InjectedFailure, get_ft_config
    from repro_torch.ft.config import ft_overrides

    Y = generate("normal_mixture", 40_001, seed=2).astype(np.float32)
    eng = ScoringEngine(M.MCTMConfig(J=2, degree=6), DataScaler.fit(Y), chunk_size=4096,
                        device=dev)
    args = dict(method="l2-hull", hull_k=400, strategy=strategy, **kw)
    g_ref = _g(5)
    ref = eng.score(Y, generator=g_ref, **args)
    g = _g(5)
    ft = get_ft_config()
    ft.simulator = FailureSimulator().inject("scoring", 6).inject("scoring", 14)
    crashes = 0
    try:
        with ft_overrides(sweep_ckpt_every_chunks=4):
            while True:
                try:
                    got = eng.score(Y, generator=g, sweep_ckpt=str(tmp_path), resume=True,
                                    **args)
                    break
                except InjectedFailure:
                    crashes += 1
    finally:
        ft.simulator = None
    assert crashes == (2 if strategy == "two-pass" else 1)
    for a, b in ((ref.scores, got.scores), (ref.gram, got.gram), (ref.hull_rows, got.hull_rows)):
        np.testing.assert_array_equal(a, b)
    assert torch.equal(g.get_state(), g_ref.get_state())


def test_resumed_stream_is_bit_identical_on_the_card(dev, tmp_path):
    """A sketched maintainer on the card killed at window 4 and resumed from
    its window checkpoint reproduces the uninterrupted coreset to the bit."""
    from repro_torch.core import mctm as M
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.streaming import StreamingCoresetMaintainer
    from repro_torch.data.dgp import generate
    from repro_torch.ft import FailureSimulator, InjectedFailure, get_ft_config

    Y = generate("normal_mixture", 8 * 8192, seed=3).astype(np.float32)
    cfg, scaler = M.MCTMConfig(J=2, degree=6), DataScaler.fit(Y)
    windows = [Y[i:i + 8192] for i in range(0, len(Y), 8192)]

    def make(**kw):
        return StreamingCoresetMaintainer(cfg, scaler, 500, 3, sketch_size=784, device=dev, **kw)

    ref = make()
    for w in windows:
        ref.push(w)
    ft = get_ft_config()
    ft.simulator = FailureSimulator().inject("streaming", 4)
    try:
        m, done, crashes = make(ckpt_dir=str(tmp_path)), 0, 0
        while done < len(windows):
            try:
                m.push(windows[done])
                done = m.windows_done
            except InjectedFailure:
                crashes += 1
                m = make(ckpt_dir=str(tmp_path))
                done = m.resume()
    finally:
        ft.simulator = None
    assert crashes == 1
    a, b = ref.result(), m.result()
    np.testing.assert_array_equal(a.Y, b.Y)
    np.testing.assert_array_equal(a.weights, b.weights)


@pytest.mark.parametrize("D,d,m,q,c,sk", [
    (176, 7, 40, None, 3001, 512), (176, 16, 0, 9, 3001, 512), (2048, 4, 33, None, 3001, 512),
    (2048, 1, 0, 5, 3001, 512), (2050, 7, 40, None, 3001, 512), (2048, 0, 0, None, 4096, 16_384),
    (2048, 0, 0, 16, 3001, 512), (2048, 7, 33, 16, 3001, 512),
])
def test_sweep_kernel_at_any_width(dev, monkeypatch, D, d, m, q, c, sk):
    """X wider than kSlabCols (D = 176, 2,048, and 2,050: the tiles' columns
    predicated one by one), through the partition and the sketch tiles: SX'
    and z to the bit against the plain version on the CPU (the bucket order
    of index_add, the fma chain of z), from a 4,096-point chunk into a
    16,384-bucket sketch (most buckets empty) too, and with Ω with and
    without P rows (d = 0: no P); the extremes to the bit and the moments
    within rtol 1e-6 / atol 1e-4 of float64; the same bits on a repeated
    call; one wide call each, and the device kernels it launches (the front
    and the tiles, and a fold with P rows). No library sort, product or
    index_add and no plain version is reached on the card."""
    from repro_torch.kernels.sweep import ops, ref

    g = _g(D + d)
    X, P = torch.rand(c, D, generator=g), torch.randn(c, d, generator=g) if d else None
    sw = torch.rand(c, generator=g)
    rows = torch.randint(0, sk, (c,), generator=g).int()
    signs = (torch.randint(0, 2, (c,), generator=g) * 2 - 1).float()
    dirs = torch.randn(m, d, generator=g) if m else None
    omega = torch.randn(D, q, generator=g) if q else None
    SX = torch.randn(sk, D, generator=g)
    mom = (torch.zeros(d), torch.zeros(d, d)) if d else None
    cuda = [None if t is None else t.to(dev) for t in (SX, X, P, sw, rows, signs, dirs, omega)]
    momc = None if mom is None else tuple(t.to(dev) for t in mom)

    def call():
        return ops.fused_sweep_update(*cuda[:6], dirs=cuda[6], omega=cuda[7], n_valid=c - 5,
                                      moments=momc)

    def refuse(*args, **kwargs):
        raise AssertionError("the sweep past kSlabCols left its kernels")

    wide = ops.PATH_LAUNCHES["wide"]
    with monkeypatch.context() as mp:
        for name in ("sort", "argsort", "matmul", "mm", "index_add"):
            mp.setattr(torch, name, refuse)
        for name in ("index_add_", "index_add", "sort", "argsort", "__matmul__"):
            mp.setattr(torch.Tensor, name, refuse)
        mp.setattr(ops, "fused_sweep_ref", refuse)
        got, again = call(), call()
    assert ops.PATH_LAUNCHES["wide"] - wide == 2
    exp = ref.fused_sweep_ref(SX, X, P, sw, rows, signs, omega=omega)
    assert _same_bits(got[0], exp[0]) and _same_bits(got[1], exp[1])
    if m:
        ext = ref.fused_sweep_ref(*cuda[:6], dirs=cuda[6], n_valid=c - 5, want_z=False)[2]
        assert all(_same_bits(a, b) for a, b in zip(got[2], ext))
    if d:
        e64 = ref.fused_sweep_ref(SX.double(), X.double(), P.double(), sw.double(), rows,
                                  signs.double(), moments=tuple(t.double() for t in mom),
                                  want_z=False)[3]
        for a, b in zip(got[3], e64):
            torch.testing.assert_close(a.cpu().double(), b, rtol=1e-6, atol=1e-4)
    assert _same_bits(again[0], got[0]) and _same_bits(again[1], got[1])
    assert _device_kernels(call) == 2 + (1 if d else 0)


@pytest.mark.parametrize("strategy", ["one-pass", "two-pass-sketched"])
@pytest.mark.parametrize("d", [17, 32, 2048])
def test_wide_p_route_beside_the_sweep(dev, monkeypatch, strategy, d):
    """P rows wider than the sweep's 16 (d = 17, 32, 2,048; P = X as a
    feature selector scores them): the sketched strategies take the sweep
    for SX and z, the extremes kernel's wide body for the chunk extremes
    (to the bit against its plain version on the same chunk) and the gram
    kernel for the moments (within rtol 1e-6 / atol 1e-4 of float64);
    neither torch.mm nor a plain version is reached on the card."""
    from repro_torch.core import scoring as TS
    from repro_torch.kernels.extremes import ops as ext_ops
    from repro_torch.kernels.extremes.ref import directional_extremes_ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.sweep import ops as sweep_ops

    c, sk, m = 2500, 1024, 48
    g = _g(d)
    X = torch.randn(c, d, generator=g).to(dev)
    sw = torch.rand(c, generator=g).to(dev)
    rows = torch.randint(0, sk, (c,), generator=g).int().to(dev)
    signs = (torch.randint(0, 2, (c,), generator=g) * 2 - 1).float().to(dev)
    dirs = torch.randn(m, d, generator=g).to(dev)
    s1, s2 = torch.randn(d, generator=g).to(dev), torch.randn(d, d, generator=g).to(dev)
    strat = (TS.OnePassSketched(sk, track_moments=True) if strategy == "one-pass"
             else TS.TwoPassSketched(sk))
    state = (torch.zeros(sk, d, device=dev), s1, s2)
    plan = (rows, signs, None) if strategy == "one-pass" else (rows, signs)

    def refuse(*args, **kwargs):
        raise AssertionError("the wide-P route left the kernels")

    counts = (sweep_ops.LAUNCHES, gram_ops.PATH_LAUNCHES["large"] + gram_ops.PATH_LAUNCHES[
        "tiled"] + gram_ops.PATH_LAUNCHES["cluster"], ext_ops.PATH_LAUNCHES["wide"])
    for mod in (sweep_ops, gram_ops, ext_ops):
        for name in ("fused_sweep_ref", "gram_ref", "directional_extremes_ref"):
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, refuse)
    monkeypatch.setattr(torch, "mm", refuse)
    monkeypatch.setattr(torch, "matmul", refuse)
    if strategy == "one-pass":
        new, z, ext = strat.fused_update(state, X, X, sw, plan, dirs=dirs)
    else:
        new, z = strat.update(state, X, X, sw, plan)
        ext = None
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert sweep_ops.LAUNCHES == counts[0] + 1
    assert (gram_ops.PATH_LAUNCHES["large"] + gram_ops.PATH_LAUNCHES["tiled"]
            + gram_ops.PATH_LAUNCHES["cluster"]) == counts[1] + 1
    if ext is not None:
        assert ext_ops.PATH_LAUNCHES["wide"] == counts[2] + 1
        want = directional_extremes_ref(X, dirs)
        assert all(_same_bits(a, b) for a, b in zip(ext, want))
    X64 = X.double()
    torch.testing.assert_close(new[1].double(), s1.double() + X64.sum(0), rtol=1e-6, atol=1e-4)
    torch.testing.assert_close(new[2].double(), s2.double() + X64.T @ X64, rtol=1e-6,
                               atol=1e-4)


def _pooled_featurize(dev, V, D, seed):
    """Mean-pooled rows of a seeded (V, D) embedding table, on ``dev``."""
    emb = torch.randn(V, D, generator=_g(seed)).to(dev)

    def featurize(tokens):
        t = torch.as_tensor(tokens).to(dev).long()
        return torch.nn.functional.embedding_bag(t, emb, mode="mean")

    return featurize


@pytest.mark.parametrize("sketch", [0, 4096])
@pytest.mark.parametrize("D", [32, 2048])
def test_coreset_selector_on_the_card(dev, monkeypatch, D, sketch):
    """``CoresetSelector`` (l2-hull) on the card against its plain versions on
    the CPU, on the same plan (sketch, hull normals, sample draw) and the
    same feature rows: scores within rtol 1e-3 (two f32 Gram orders on
    well-conditioned pooled rows), the sampled ids equal, the hull ids ≥ 90%
    shared, Σ weights within 1e-3 of each other; on the card no plain
    version runs (the gram, sweep and extremes kernels take every width)."""
    from repro_torch.core import scoring as TS
    from repro_torch.data import pipeline as TP
    from repro_torch.kernels.extremes import ops as ext_ops
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.sweep import ops as sweep_ops

    n, k, seq = (4096, 512, 16) if D == 32 else (1024, 128, 16)  # the CPU side's extremes
    tokens = torch.randint(0, 5000, (n, seq), generator=_g(D))
    feats = {d: _pooled_featurize(d, 5000, D, D + 1) for d in (dev, torch.device("cpu"))}
    g = _g(sketch + D)
    k2 = k - int(0.8 * k)
    plan = {"draw": torch.randint(0, n, (int(0.8 * k),), generator=g).numpy()}
    if sketch:
        plan["sketch"] = (torch.randint(0, sketch, (n,), generator=g),
                          torch.randint(0, 2, (n,), generator=g) * 2.0 - 1)
        plan["hull_normals"] = torch.randn(4 * k2, D, generator=g).numpy()
    else:
        P = feats[torch.device("cpu")](tokens).double()
        s1, s2 = P.sum(0), P.T @ P
        plan["hull_dirs"] = TS.directions_from_moments(
            s1, s2, n, k2, normals=torch.randn(4 * k2, D, generator=g).numpy())

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card")

    scores = []  # the CPU's result, then the card's
    real_score = TS.ScoringEngine.score

    def keep(self, *a, **kw):
        scores.append(real_score(self, *a, **kw))
        return scores[-1]

    monkeypatch.setattr(TS.ScoringEngine, "score", keep)
    cpu = TP.CoresetSelector(feats[torch.device("cpu")], sketch_size=sketch, chunk_size=1500,
                             device="cpu").select(tokens.numpy(), k, plan=plan)
    for mod, name in ((gram_ops, "gram_ref"), (sweep_ops, "fused_sweep_ref"),
                      (ext_ops, "directional_extremes_ref")):
        monkeypatch.setattr(mod, name, refuse)
    before = (gram_ops.LAUNCHES, sweep_ops.LAUNCHES, ext_ops.LAUNCHES)
    got = TP.CoresetSelector(feats[dev], sketch_size=sketch, chunk_size=1500,
                             device=dev).select(tokens, k, plan=plan)
    monkeypatch.undo()
    after = (gram_ops.LAUNCHES, sweep_ops.LAUNCHES, ext_ops.LAUNCHES)
    assert after[2] > before[2] and (after[1] > before[1] if sketch else after[0] > before[0])
    np.testing.assert_allclose(scores[1].scores, scores[0].scores, rtol=1e-3)
    kk = int(0.8 * k)
    np.testing.assert_array_equal(got.indices[:kk], cpu.indices[:kk])
    np.testing.assert_allclose(got.weights[:kk], cpu.weights[:kk], rtol=1e-3)
    shared = np.intersect1d(got.indices[kk:], cpu.indices[kk:]).size
    assert shared >= 0.9 * k2 and np.unique(got.indices[kk:]).size == k2
    assert got.weights.sum() == pytest.approx(cpu.weights.sum(), rel=1e-3)


def test_density_engine_graphs_are_the_eager_functions(dev):
    """Each (kind, bucket) CUDA graph replays the bits of an eager call of
    the same function on the same static inputs; captures happen in warmup
    only (none across publishes); each replay runs the bernstein kernel;
    log densities within 1e-5·max(1, |ref|) of ``mctm.log_density`` of the
    version each answer records."""
    from repro_torch.core import mctm as TM
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.serve.density import DensityServeEngine, bucket_for

    cfg = TM.MCTMConfig(J=2, degree=6)
    Y = (torch.randn(600, 2, generator=_g(1)) * torch.tensor([1.0, 2.0])).numpy()
    scaler = DataScaler.fit(Y)
    p0 = TM.init_params(cfg, generator=_g(2), device="cpu")
    p1 = TM.ParamLeaves(p0.theta_raw.detach() + 0.3, p0.lam.detach() - 0.2)
    eng = DensityServeEngine(cfg, p0, scaler, max_batch=64, min_bucket=8, device=dev)
    assert eng.warmup() == 2 * len(eng.buckets)
    reqs = []
    for i, burst in enumerate((3, 8, 13, 64, 40, 1)):
        reqs += eng.submit_log_density(Y[i * 64:i * 64 + burst])
        eng.submit_sample(burst, y_obs=Y[i], n_obs=i % 3, seeds=list(range(burst)))
        if i == 3:
            eng.publish(p1)
        eng.step()
        for kind in ("log_density", "sample"):
            ex = eng._execs[(kind, bucket_for(burst, eng.buckets))]
            args = ((eng._static["low"], eng._static["high"], eng._static["inv_span"],
                     ex.inputs["Y"]) if kind == "log_density" else
                    (eng._static["low"], eng._static["high"], ex.inputs["z"],
                     ex.inputs["y_obs"], ex.inputs["n_obs"]))
            with torch.no_grad():
                eager = eng._fns[kind](eng._params(), *args)
            assert _same_bits(eager, ex.out)
    eng.run_until_drained()
    assert eng.compile_count == 2 * len(eng.buckets)
    assert eng.replayed_launches["bernstein"] >= 2 * 6
    for v, p in ((0, p0), (1, p1)):
        rows = [r for r in reqs if r.version == v]
        assert rows
        with torch.no_grad():
            ref = TM.log_density(cfg, TM.ParamLeaves(p.theta_raw.detach().to(dev),
                                                     p.lam.detach().to(dev)), scaler,
                                 torch.as_tensor(np.stack([r.y for r in rows]), device=dev))
        for r, e in zip(rows, ref.cpu().tolist()):
            assert abs(r.result - e) <= 1e-5 * max(1.0, abs(e))
