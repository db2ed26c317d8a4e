"""Each kernel's plain PyTorch version (``repro_torch/kernels/*/ref.py``, the
CPU path of the port) against the JAX package's Pallas kernel run with
``interpret=True`` on the same numpy inputs.

Tolerances: gram rtol 1e-5 of max|G| (f32 sums in another order); extremes
values atol 1e-4 with exact indices (the reference's tests/test_kernels.py);
sweep SX and z atol/rtol 1e-6, moments atol 1e-4, exact indices (the
reference's tests/test_sweep_kernel.py::_check); bernstein atol 1e-6.

Below those, plain torch/numpy models of the order in which the redesigned
CUDA kernels compute (the bucket-owner sketch of ``csrc/sweep.cu`` and the
tile-max + rescan extremes of ``csrc/common.cuh``) are held to the plain
versions bit for bit, with the launch plans the wrappers hand the kernels.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from gram_tiled_plan_model import gram_constants, tiled_plan_model  # noqa: E402

from repro.core.scoring import sketch_plan  # noqa: E402
from repro.kernels.bernstein.ops import bernstein_basis_deriv  # noqa: E402
from repro.kernels.extremes.ops import directional_extremes  # noqa: E402
from repro.kernels.gram.ops import gram_matrix  # noqa: E402
from repro.kernels.sweep.ops import fused_sweep_update  # noqa: E402
from repro_torch.core import scoring as TS  # noqa: E402
from repro_torch.kernels import _lib  # noqa: E402
from repro_torch.kernels.bernstein import ops as tbern  # noqa: E402
from repro_torch.kernels.extremes import ops as text  # noqa: E402
from repro_torch.kernels.extremes.ref import direction_scores  # noqa: E402
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
    got_basis, got_deriv = tbern.bernstein_basis_deriv(_t(t), degree)
    np.testing.assert_allclose(got_basis.numpy(), np.asarray(basis), atol=1e-6)
    np.testing.assert_allclose(got_deriv.numpy(), np.asarray(deriv), atol=1e-6)


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


@pytest.mark.parametrize("D", [65, 70, 72, 80, 81, 96, 97, 112, 113, 128, 129, 140, 144, 145, 160])
def test_gram_tiled_plan_covers_the_upper_triangle_once(D):
    """gram's tiled body (64 < D ≤ 160) takes its warps' tile runs from
    ``csrc/gram.cu``'s ``make_tiled_plan``, modelled here
    (``tests/gram_tiled_plan_model.py``; the card test
    ``test_gram_tiled_plan_is_the_model`` holds the C plan to the model):
    every 16×8 tile (i, j ≥ 2i) of the triangle in exactly one run, each run
    within two strips, no more runs than warps, the run width one the kernel
    is built for, and the counts the kernel's header gives at D 70 and 140."""
    C = gram_constants()
    W, runs = tiled_plan_model(D)
    M, N = -(-D // 16), -(-D // 8)
    assert C["kWideMinRunTiles"] <= W <= C["kWideMaxRunTiles"]
    assert 1 <= len(runs) <= C["kWideMaxGroups"]
    seen = []
    for i0, j0, split, cnt in runs:
        assert 1 <= split <= cnt <= W and 0 <= i0 < M and 2 * i0 <= j0
        seen += [(i0, j0 + q) for q in range(split)]
        seen += [(i0 + 1, 2 * (i0 + 1) + q) for q in range(cnt - split)]
    want = [(i, j) for i in range(M) for j in range(2 * i, N)]
    assert sorted(seen) == want
    assert all(8 * j < D and 16 * i < D for i, j in seen)
    # every entry a ≤ b < D of G lies in one of the tiles
    cover = np.zeros((D, D), bool)
    for i, j in seen:
        cover[16 * i:16 * i + 16, 8 * j:8 * j + 8] = True
    assert cover[np.triu_indices(D)].all()
    header = {70: (2, 25, 13), 140: (6, 90, 15)}  # W, tiles, runs
    if D in header:
        assert (W, len(seen), len(runs)) == header[D]
    # the scratch holds a (sum, compensation) pair of every fragment slot of
    # every cluster at the widest plan
    slots = 4 * W * 32 * len(runs)
    assert C["kWideMaxClusters"] * 2 * slots <= tgram._C["kWideScratchFloats"]


def _tf32(x: np.ndarray) -> np.ndarray:
    """f32 → TF32 as ``cvt.rna.tf32.f32``: nearest, ties away from zero."""
    bits = x.astype(np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


@pytest.mark.parametrize("D", [70, 140])
def test_gram_tiled_split_products_hold_f32_accuracy(D):
    """The tiled body's arithmetic on the CPU: each √w·x split into hi =
    tf32(x) and lo = x − hi, which the tensor core reads with its low 13
    bits dropped, and every product taken as lo·hi + hi·lo + hi·hi (exact
    in the tensor cores; float64 here). Over a
    16,384-row chunk of Bernstein-like features the Gram lies within
    1e-6·max|G| of float64 — 10× inside the kernel's 1e-5 — while one TF32
    product (hi·hi alone, what a TF32 flag would give) lies outside 1e-5."""
    rng = np.random.default_rng(D)
    X = rng.beta(0.5, 0.5, (16_384, D)).astype(np.float32)
    sw = np.sqrt(rng.uniform(0.2, 2.0, 16_384)).astype(np.float32)
    Xw = X * sw[:, None]  # rounded to f32 as the kernel and the plain version do
    hi = _tf32(Xw)
    lo = ((Xw - hi).view(np.uint32) & np.uint32(0xFFFFE000)).view(np.float32)
    hi64, lo64 = hi.astype(np.float64), lo.astype(np.float64)
    exact = Xw.astype(np.float64).T @ Xw.astype(np.float64)
    split3 = lo64.T @ hi64 + hi64.T @ lo64 + hi64.T @ hi64
    one = hi64.T @ hi64
    scale = np.abs(exact).max()
    assert np.abs(split3 - exact).max() <= 1e-6 * scale
    assert np.abs(one - exact).max() > 1e-5 * scale


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


@pytest.mark.parametrize("d", [17, 33, 70, 1024])
@pytest.mark.parametrize("rows,m,n_valid", [(777, 40, 700), (1030, 130, 1030)])
def test_extremes_ref_matches_reference_at_wide_d(d, rows, m, n_valid):
    """The plain version of the kernel's wide body (d > 16) against the JAX
    package's oracle (``repro.kernels.extremes.ref``): the same indices,
    first occurrence on the exact ties of the copied half; values within
    float32 summation-order noise (rtol 1e-5)."""
    from repro.kernels.extremes.ref import directional_extremes_ref as jax_ref

    P, dirs = _extremes_case(rows, m, d, rows + m + d, True)
    ref = jax_ref(jnp.asarray(P), jnp.asarray(dirs), jnp.arange(rows) < n_valid)
    got = text.directional_extremes(_t(P), _t(dirs), n_valid)
    for g, r, name in zip(got, ref, ("vmax", "imax", "vmin", "imin")):
        if name.startswith("i"):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
            assert int(g.max()) < n_valid
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def _wide_schedule(rows: int, n_valid: int, m: int, plan) -> tuple[np.ndarray, int, np.ndarray]:
    """What ``csrc/extremes.cu``'s wide body does under ``plan``, by warp:
    (the times each (direction, row) enters the extremes, the most padded
    directions a working warp scores, the times each (row block, direction)
    partial is written). A warp of tile 0 takes 32 directions × 64 rows of
    a tile, of tile 1 the one direction × 32 rows; it works only when it has
    a direction and a scored row; a CTA writes its partial of each of its
    directions once, after folding its warps along the rows."""
    td, tr, _ = text.WIDE_TILES[plan.tile]
    wdirs = text.WARP_DIRS if plan.tile == 0 else 1
    wd = td // wdirs
    wrows = 8 * text._W["kExtWideRr"] if plan.tile == 0 else 32  # rows a warp: 8 lanes × Rr, or 32 × 1
    parts = tr // wrows
    scored = np.zeros((m, rows), np.int32)
    written = np.zeros((plan.nrb, m), np.int32)
    padded = 0
    for bx in range(plan.nrb):
        base = bx * plan.rb
        nv = max(0, min(plan.rb, rows - base, n_valid - base))
        for by in range(-(-m // td)):
            nd = min(td, m - by * td)
            for w in range(wd * parts):
                k, r = w % wd, w // wd
                d0, d1 = by * td + k * wdirs, min(m, by * td + (k + 1) * wdirs)
                if k * wdirs >= nd:
                    continue
                if r == 0:
                    written[bx, d0:d1] += 1
                for t in range(-(-nv // tr)):
                    r0 = t * tr + r * wrows
                    if r0 < nv:
                        scored[d0:d1, base + r0:base + min(r0 + wrows, nv)] += 1
                        padded = max(padded, (k + 1) * wdirs - (d1 - by * td))
    return scored, padded, written


@pytest.mark.parametrize("rows,n_valid,m", [
    (16_384, 16_384, 1614), (16_384, 16_384, 128), (16_384, 16_384, 1), (1_000, 1_000, 5736),
    (3001, 2900, 130), (700, 513, 1), (3001, 2999, 8), (5003, 4711, 1614), (7, 7, 9), (0, 0, 5),
    (327_680, 327_680, 3)])
def test_extremes_wide_launch_plan_covers_every_direction_and_row(rows, n_valid, m):
    """The wide body's plan on the H100's 132 SMs: every scored row of
    every direction enters the extremes once; no direction past m is
    scored but those of the last warp of a 32-direction tile (none at m =
    1, whose tile is one direction); the scratch's nrb·m partials are each
    written once; blocks are whole tiles of rows, and the path's shapes
    take the tiles and grids the kernel was timed with."""
    plan = text.wide_launch_plan(rows, m, 132)
    _, tr, _ = text.WIDE_TILES[plan.tile]
    assert plan.rb % tr == 0 and plan.nrb * plan.rb >= rows > (plan.nrb - 1) * plan.rb
    assert plan.tile == (1 if m == 1 else 0)
    scored, padded, written = _wide_schedule(rows, n_valid, m, plan)
    assert (scored[:, :n_valid] == 1).all() and not scored[:, n_valid:].any()
    assert padded < (text.WARP_DIRS if plan.tile == 0 else 1)
    assert (written == 1).all()
    want = {(16_384, 1614): (0, 896, 19), (16_384, 128): (0, 128, 128),
            (16_384, 1): (1, 128, 128), (3001, 130): (0, 128, 24)}
    if (rows, m) in want:
        assert tuple(plan) == want[(rows, m)]


def test_extremes_wide_plan_at_the_route():
    """The wide-P route's 5,736 directions at d = 2,048: tiles of 128 × 128
    rows, two tiles a block, 2,880 CTAs (11 waves of 264)."""
    assert tuple(text.wide_launch_plan(16_384, 5736, 132)) == (0, 256, 64)


@pytest.mark.parametrize("n,D", [(16_384, 2048), (16_384, 2052), (16_387, 161), (70_001, 256),
                                 (1000, 300), (0, 161), (1, 2048), (16_384, 4096)])
def test_gram_large_plan_covers_every_upper_tile_and_row(n, D):
    """The large body's plan: the tiles of blockIdx.x (the kernel's row-by-
    row walk) are G's upper triangle of 128-tiles, each entry a ≤ b < D in
    one; the splits' spans of whole 32-row stages cover the rows once, none
    empty but at n = 0; the scratch holds the (sum, compensation) planes of
    every (split, tile) the kernel writes, at the index the fold reads."""
    T = tgram._C["kLargeTile"]
    tiles, splits = tgram.large_plan(n, D)
    nb = -(-D // T)
    walk = [(bi, bj) for bi in range(nb) for bj in range(bi, nb)]
    assert tiles == len(walk) and 1 <= splits <= tgram._C["kLargeMaxSplits"]
    for t, (bi, bj) in enumerate(walk):  # the fold's index of a tile is the walk's
        assert bi * nb - bi * (bi - 1) // 2 + bj - bi == t
    cover = np.zeros((D, D), np.int32)
    for bi, bj in walk:
        cover[bi * T:(bi + 1) * T, bj * T:(bj + 1) * T] += 1
    assert (cover[np.triu_indices(D)] == 1).all()
    rows = tgram._C["kLargeStageRows"]
    span = -(-(-(-n // splits)) // rows) * rows
    spans = [(min(n, s * span), min(n, (s + 1) * span)) for s in range(splits)]
    assert spans[0][0] == 0 and spans[-1][1] == n
    assert all(a < b for a, b in spans) or n == 0
    # the kernel's writes: split s, tile t at (s·tiles + t)·2·T², two planes of T²
    last = ((splits - 1) * tiles + tiles - 1) * 2 * T * T + 2 * T * T
    assert last == splits * tiles * 2 * T * T
    if (n, D) == (16_384, 2048):
        assert (tiles, splits) == (136, 9)


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


# --------------------------------------------------------------------------
# the redesigned kernels' order, modelled on the CPU


def _bucket_owner_sketch(SX, X, sw, rows, signs, *, bk, step, cap=4096):
    """SX' in the order of csrc/sweep.cu's sketch CTAs: buckets in ranges of
    bk; per range, the points that land in it compacted in ascending order,
    `step` points a step, and flushed once more than cap − step are held; a
    flush adds sign·(x·√w) to each bucket's row, the bucket's points in list
    order (a stable sort by bucket), starting from the carry."""
    V = (signs[:, None] * (X * sw[:, None])).numpy()
    out = SX.numpy().copy()
    rows = rows.numpy().astype(np.int64)
    c, sk = X.shape[0], SX.shape[0]

    def flush(seg):
        ids = np.asarray(seg, dtype=np.int64)
        for pt in ids[np.argsort(rows[ids], kind="stable")]:
            out[rows[pt]] = out[rows[pt]] + V[pt]

    for lo in range(0, sk, bk):
        hit = (rows >= lo) & (rows < min(sk, lo + bk))
        seg = []
        for t0 in range(0, c, step):
            seg += (np.nonzero(hit[t0:t0 + step])[0] + t0).tolist()
            if len(seg) > cap - step:
                flush(seg)
                seg = []
        if seg:
            flush(seg)
    return torch.from_numpy(out)


@pytest.mark.parametrize("sk,D,r,skew", [(784, 14, 2, False), (784, 14, 2, True),
                                         (19_600, 70, 10, False)])
def test_bucket_owner_sketch_order_equals_plain_version(sk, D, r, skew):
    """The default one-pass sketch 4·D² at J = 2 and J = 10 over a 16,384-point
    chunk, from a nonzero carry: the kernel's order gives the bits of
    ``fused_sweep_ref``'s SX' (index_add on the CPU adds the points one by
    one in ascending order). ``skew`` puts every point in 8 buckets, so one
    range is flushed several times."""
    c = 16_384
    rng = np.random.default_rng(sk + skew)
    X = torch.from_numpy(rng.standard_normal((c, D)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.0, 2.0, c).astype(np.float32))
    rows = torch.from_numpy(rng.integers(0, 8 if skew else sk, c).astype(np.int32))
    signs = torch.from_numpy((rng.integers(0, 2, c) * 2 - 1).astype(np.float32))
    SX = torch.from_numpy(rng.standard_normal((sk, D)).astype(np.float32))
    plan = tsweep.launch_plan(c, D, r, 7, sk, 1614, 132)
    assert plan["ns"] * plan["bk"] >= sk
    got = _bucket_owner_sketch(SX, X, sw, rows, signs, bk=plan["bk"],
                               step=8 * max(256, 32 * plan["warps"]))
    ref = fused_sweep_ref(SX, X, None, sw, rows, signs, want_z=False)[0]
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))


def _partition_tiles_sketch(SX, X, sw, rows, signs, plan):
    """(SX', z) in the order of csrc/sweep.cu past kSlabCols. The partition:
    unit g is W warps, warp w taking part_pts points from (g·W + w)·part_pts;
    each warp counts its points by range row // bk into cell (range, w), the
    unit scans its cells in (range, warp) order, and each warp walks its
    points again 32 at a time (a step), a point's place its cell's cursor
    plus its rank among the step's points of that range; cell (r, W − 1)
    ends as range r's segment end. The tiles: per (range, slab of 4·T
    columns), the segment of every unit in unit order (the bisection over
    the scanned segment lengths), each entry's x once: z = √w·x, and
    sign·(√w·x) added to its bucket's row in list order, from the carry.
    SX' and z start as NaN, so a column no slab covers shows."""
    bk, nr, T, slabs = plan["bk"], plan["ns"], plan["tile_threads"], plan["slabs"]
    parts, W, S = plan["parts"], plan["part_warps"], plan["part_pts"]
    Xn, swn, sgn = X.numpy(), sw.numpy(), signs.numpy()
    rows = rows.numpy().astype(np.int64)
    c, D = Xn.shape
    sk = SX.shape[0]
    lst = np.full(max(c, 1), -1, dtype=np.int64)
    end = np.zeros((parts, nr), dtype=np.int64)
    for g in range(parts):
        base = g * W * S
        cells = np.zeros((nr, W), dtype=np.int64)
        for w in range(W):
            p0 = base + w * S
            cells[:, w] = np.bincount(rows[p0:min(c, p0 + S)] // bk, minlength=nr)
        cur = (np.cumsum(cells.ravel()) - cells.ravel()).reshape(nr, W)
        for w in range(W):
            p0, p1 = base + w * S, min(c, base + w * S + S)
            for t0 in range(p0, max(p0, p1), 32):
                step = rows[t0:min(p1, t0 + 32)] // bk
                for lane, r in enumerate(step):
                    lst[base + cur[r, w] + int((step[:lane] == r).sum())] = t0 + lane
                for r in np.unique(step):
                    cur[r, w] += int((step == r).sum())
        end[g] = cur[:, W - 1]
    out = np.full(SX.shape, np.nan, dtype=np.float32)
    z = np.full(Xn.shape, np.nan, dtype=np.float32)
    SXn = SX.numpy()
    for r in range(nr):
        lo, nb = r * bk, min(bk, sk - r * bk)
        beg = end[:, r - 1] if r else np.zeros(parts, dtype=np.int64)
        pre = np.concatenate([[0], np.cumsum(end[:, r] - beg)])
        ents = []
        for e in range(int(pre[-1])):
            u = int(np.searchsorted(pre[:-1], e, side="right")) - 1
            ents.append(int(lst[u * W * S + beg[u] + e - pre[u]]))
        for s_ in range(slabs):
            cols = slice(s_ * 4 * T, min(D, (s_ + 1) * 4 * T))
            acc = SXn[lo:lo + nb, cols].copy()
            for pt in ents:
                xw = Xn[pt, cols] * swn[pt]
                z[pt, cols] = xw
                acc[rows[pt] - lo] = acc[rows[pt] - lo] + sgn[pt] * xw
            out[lo:lo + nb, cols] = acc
    return torch.from_numpy(out), torch.from_numpy(z)


@pytest.mark.parametrize("D,sk,c,case", [
    (161, 16_384, 4096, "sk = 4c"), (176, 16_384, 300, "more buckets than points"),
    (2048, 512, 1200, "one bucket"), (2050, 512, 777, "n_valid < c"), (176, 512, 4096, "skew"),
    (161, 512, 0, "empty chunk"),
])
def test_partition_tiles_sketch_order_equals_plain_version(D, sk, c, case):
    """Past kSlabCols: the stable partition by bucket range and the sketch
    tiles, with the plan the wrapper hands the kernel, give the bits of
    ``fused_sweep_ref``'s SX' and z from a nonzero carry: a sketch 4× the
    chunk, more buckets than points, every point in one bucket, D no
    multiple of 4 with n_valid < c (the sketch takes every row), 8 buckets
    for 4,096 points, and an empty chunk."""
    rng = np.random.default_rng(D + sk + c)
    X = torch.from_numpy(rng.standard_normal((c, D)).astype(np.float32))
    sw = torch.from_numpy(rng.uniform(0.0, 2.0, c).astype(np.float32))
    hi = {"one bucket": 1, "skew": 8}.get(case, sk)
    rows = torch.from_numpy((rng.integers(0, hi, c) + (sk - hi) // 2).astype(np.int32))
    signs = torch.from_numpy((rng.integers(0, 2, c) * 2 - 1).astype(np.float32))
    SX = torch.from_numpy(rng.standard_normal((sk, D), dtype=np.float32))
    plan = tsweep.launch_plan(c, D, 1, 1, sk, 0, 132)
    got = _partition_tiles_sketch(SX, X, sw, rows, signs, plan)
    ref = fused_sweep_ref(SX, X, None, sw, rows, signs, n_valid=max(0, c - 5))
    for g, e in zip(got, ref[:2]):
        assert torch.equal(g.view(torch.int32), e.view(torch.int32))


@pytest.mark.parametrize("c,D,sk", [(16_384, 2048, 16_384), (16_384, 300, 4096), (3001, 176, 512),
                                    (3001, 2048, 512), (4096, 161, 16_384), (777, 2050, 512),
                                    (0, 161, 512), (65_536, 2048, 16_384), (16_384, 2048, 1)])
def test_sweep_wide_plan_covers_every_bucket_and_column(c, D, sk):
    """The plan past kSlabCols at the phase-9 shape (D 2,048, sketch 16,384),
    the timed D 300 shape and the test shapes: ranges of 4, 8 or 16 buckets
    cover every bucket once, slabs of 4·T columns cover D, the units cover
    the chunk, and the front launch's block CTAs (with P rows of d = 16 and
    staged √w·X at worst) and a tile's static shared memory fit the H100."""
    const = _lib.CUDA_CONSTANTS["sweep.cu"]
    tile_smem = 4 * (2 * const["kMaxParts"] + 1) + 16 * const["kTileEntries"]
    for r, d, m in ((1, 1, 0), (1, 7, 1614), (2, 16, 130)):
        plan = tsweep.launch_plan(c, D, r, d, sk, m, 132)
        bk, nr, T, slabs = plan["bk"], plan["ns"], plan["tile_threads"], plan["slabs"]
        assert bk in (4, 8, 16) and nr * bk >= sk > (nr - 1) * bk
        assert T % 32 == 0 and 32 <= T <= tsweep.WIDE_TILE_THREADS
        assert slabs * 4 * T >= D > (slabs - 1) * 4 * T
        assert 1 <= plan["parts"] <= 64 and plan["part_pts"] % 32 == 0
        assert plan["parts"] * plan["part_warps"] * plan["part_pts"] >= c
        threads = max(256, 32 * plan["warps"]) if m else 256
        assert plan["part_warps"] == threads // 32  # the front launch's warps
        assert plan["nblk"] * plan["pb"] >= c and plan["pb"] * r <= tsweep.MAX_BLOCK_ROWS
        staged = plan["pb"] * D if plan["pb"] * D <= 12_288 else 0
        front = 4 * (plan["pb"] * r * (-(-d // 4) * 4) + staged + threads)
        assert front <= 232_448 and tile_smem <= 48 * 1024  # a tile's is static
    if (c, D, sk) == (16_384, 2048, 16_384):
        assert (bk, nr, T, slabs, plan["parts"], plan["part_pts"]) == (16, 1024, 128, 4, 16, 128)


def _tile_rescan_extremes(P, dirs, n_valid, *, rb, tile, reverse_fold):
    """(vmax, imax, vmin, imin) in the order of csrc/common.cuh: per block of
    rb rows, the running max/min over tiles of `tile` rows taken from each
    tile's max/min with strict comparisons, so a block's partial is its
    extreme and the first row of the first tile attaining it; the partials
    folded by (value, lowest row), here in either order; then one rescan of
    the winning tile for the first row whose score equals the extreme."""
    S = direction_scores(P, dirs)
    rows, m = P.shape[0], dirs.shape[0]
    inf = torch.full((m,), float("inf"))
    parts = []
    for base in range(0, rows, rb):
        nv = max(0, min(rb, rows - base, n_valid - base))
        ext = []
        for sign in (1.0, -1.0):  # max, then min as the max of −S
            best, start = -inf, torch.full((m,), base)
            for t0 in range(0, nv, tile):
                hi = (sign * S[:, base + t0:base + min(nv, t0 + tile)]).amax(1)
                up = hi > best
                best, start = torch.where(up, hi, best), torch.where(up, base + t0, start)
            ext += [sign * best, start]
        parts.append(ext)
    out = [-inf, torch.full((m,), 2**31 - 1), inf, torch.full((m,), 2**31 - 1)]
    for vx, ix, vn, in_ in (reversed(parts) if reverse_fold else parts):
        up = (vx > out[0]) | ((vx == out[0]) & (ix < out[1]))
        out[0], out[1] = torch.where(up, vx, out[0]), torch.where(up, ix, out[1])
        up = (vn < out[2]) | ((vn == out[2]) & (in_ < out[3]))
        out[2], out[3] = torch.where(up, vn, out[2]), torch.where(up, in_, out[3])
    for v, i in ((0, 1), (2, 3)):  # the rescan: rows past n_valid follow every valid one
        for k in range(m):
            t0 = int(out[i][k])
            seg = S[k, t0:min(rows, t0 + tile)]
            hit = torch.nonzero(seg == out[v][k])
            if hit.numel():
                out[i][k], out[v][k] = t0 + int(hit[0, 0]), seg[int(hit[0, 0])]
        out[i] = out[i].to(torch.int32)
    return tuple(out)


def _signed_zero_case(rows, m, d, seed):
    """Scores ≤ 0 everywhere (P ≤ 0, dirs > 0), with rows of −0 and +0: the
    max is 0, first reached at a −0 row, then +0 and −0 rows tie with it."""
    rng = np.random.default_rng(seed)
    P = -np.abs(rng.standard_normal((rows, d))).astype(np.float32)
    for i, z in ((5, -0.0), (9, 0.0), (rows // 2, -0.0), (rows - 2, 0.0)):
        P[i] = z
    dirs = np.abs(rng.standard_normal((m, d))).astype(np.float32) + 0.1
    dirs[::3] *= -1  # these have 0 as their min: +0 products of −0 rows
    return P, dirs


@pytest.mark.parametrize("rb,tile", [(16, 16), (128, 16), (48, 16), (64, 8), (96, 32), (50, 3)])
@pytest.mark.parametrize("case", ["ragged", "tied", "zeros"])
def test_tile_rescan_extremes_equal_the_dense_argmax(rb, tile, case):
    """The tile-max fold and the one rescan of the winning tile, over several
    tile sizes and row-block splits, the blocks folded in either order, equals
    ``directional_extremes_ref`` bit for bit: exact ties (the first copy
    wins), a ragged n_valid, and ±0 scores (the sign of the reported zero
    is the first occurrence's)."""
    rows, m, d = 1030, 37, 7
    if case == "zeros":
        P, dirs = _signed_zero_case(rows, m, d, rb + tile)
        n_valid = rows
    else:
        P, dirs = _extremes_case(rows, m, d, rb * tile, tie=case == "tied")
        n_valid = 701 if case == "ragged" else rows
    Pt, Dt = _t(P), _t(dirs)
    ref = directional_extremes_ref(Pt, Dt, n_valid)
    for reverse in (False, True):
        got = _tile_rescan_extremes(Pt, Dt, n_valid, rb=rb, tile=tile, reverse_fold=reverse)
        for g, e in zip(got, ref):
            assert torch.equal(g.view(torch.int32), e.view(torch.int32))
    if case == "zeros":
        assert int(ref[1][1]) == 5 and bool(torch.signbit(ref[0][1]))  # −0 at row 5


def test_extremes_launch_plan_covers_every_direction_and_row():
    """The plan handed to csrc/extremes.cu: blocks a multiple of the 16-row
    tile and at most 512 rows, CTAs of at most 16 warps covering m, and
    about two CTAs an SM at the path's (32,768 × 7) × 1,614."""
    assert text.launch_plan(32_768, 1614, 132) == (128, 13, 256)
    assert text.launch_plan(32_768, 414, 132) == (128, 4, 256)
    for rows in (1, 7, 513, 32_768, 327_680):
        for m in (1, 127, 128, 129, 1614, 2049, 5000):
            rb, warps, nblk = text.launch_plan(rows, m, 132)
            cta_rows = -(-m // (128 * warps))
            assert rb % 16 == 0 and rb <= 512 and nblk * rb >= rows > (nblk - 1) * rb
            assert 1 <= warps <= 16 and cta_rows * warps * 128 >= m


@pytest.mark.parametrize("J", [2, 10, 20])
def test_sweep_launch_plan_fits_the_kernel(J):
    """The default one-pass sketch 4·D² at J = 2, 10 and 20 (degree 6) over a
    16,384-point chunk: sketch ranges cover every bucket, each copying
    about SKETCH_FLOATS of SX at most, block CTAs cover every point with at most 512 P rows
    each, and at the path's J = 2 sketch and block CTAs together fill about
    two CTAs an SM."""
    D, c, d = 7 * J, 16_384, 7
    sk = 4 * D * D
    plan = tsweep.launch_plan(c, D, J, d, sk, 1614, 132)
    assert plan["ns"] * plan["bk"] >= sk > (plan["ns"] - 1) * plan["bk"]
    assert plan["bk"] * D <= tsweep.SKETCH_FLOATS + D
    assert plan["pb"] * J <= tsweep.MAX_BLOCK_ROWS
    assert plan["pb"] * (D + J * 8) <= tsweep.BLOCK_FLOATS
    alone = tsweep.launch_plan(c, D, 1, 1, sk, 0, 132)  # z alone: no P rows
    assert alone["pb"] * (D + 4) <= tsweep.BLOCK_FLOATS
    assert plan["nblk"] * plan["pb"] >= c > (plan["nblk"] - 1) * plan["pb"]
    assert plan["warps"] == 13  # 1,614 directions: 13 warps of 128
    if J == 2:
        assert plan["ns"] + plan["nblk"] <= 2 * 132
