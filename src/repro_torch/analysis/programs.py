"""The port's registered hot paths, on small audit shapes.

Importing this module populates the registry (see
:mod:`repro_torch.analysis.registry`) with a counterpart of each of the
reference's 19 programs (``repro.analysis.programs``), under the same
names (``*_kernel_interpret`` becomes ``*_kernel``: the port's wrappers
have no interpret mode). Each builder reconstructs its program the way
its production call site does — the same makers, the same mesh layout —
and the auditor calls it once.

Shape choices (the reference's, why these numbers):

* ``N = 3,072`` rows over ``SHARDS = 8`` ranks of a fake world, ``CHUNK =
  32`` with ``CPS = 12`` chunks a rank: rank 0's stacked basis (CPS·CHUNK·
  J·d = 3,072 elems) overflows the 2,048-elem chunk budget, so stacking is
  detectable, while the largest legitimate fixed block (the extremes' score
  tile, m_dirs × chunk·J = 24 × 64 = 1,536) stays inside it.
* ``J = 2, DEGREE = 3`` → d = 4, basis width D = J·d = 8: every basis block
  has 8 elements a row, wider than every legitimate row-scaled array (Y has
  J = 2, the one-pass z keeps q = 2 < D), which is what lets ``row_elems =
  2`` separate "streams with n" from "materializes the basis".
* Collective budgets are exact where the reference's are (every collective
  of the port is written by hand: ``DataMesh.fold``, the gather pair), and a
  fold is one call however many tensors it packs, so the reference's "one
  all-reduce per element of the fused psum" becomes one ``fold`` a sweep.
  The sharded train step and the L-BFGS oracles keep the reference's
  ceilings (COLL-CEILING): at most one fold, none may be added.

``make_programs(shapes)`` builds the same programs at other shapes;
``chip_smoke.py`` phase 13 runs the scoring, fit and drift programs at the
MCTM path's width (``PHASE3``) on the card.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.registry import (
    CollectiveBudget,
    MaterializationBudget,
    ProgramSpec,
    register,
)

__all__ = ["Shapes", "AUDIT", "PHASE3", "make_programs", "WIDTH_PROGRAMS"]


@dataclasses.dataclass(frozen=True)
class Shapes:
    """The audit's data and layout: ``shards`` ranks of ``cps`` chunks of
    ``chunk`` rows (``n`` rows in all unless given)."""

    shards: int = 8
    chunk: int = 32
    cps: int = 12
    J: int = 2
    degree: int = 3
    hull_k: int = 4
    sketch: int = 16
    proj_q: int = 2
    mb: int = 4               # train-step microbatches
    seg_chunks: int = 10      # a segment's chunks; 10·(chunk·J·d) > fixed_segmented
    n_rows: int | None = None
    serve_bucket: int = 32
    serve_grid: int = 512

    @property
    def n(self) -> int:
        return self.n_rows if self.n_rows is not None else self.shards * self.cps * self.chunk

    @property
    def d(self) -> int:
        return self.degree + 1

    @property
    def D(self) -> int:
        return self.J * self.d

    @property
    def rank_chunks(self) -> int:
        """Rank 0's chunks in the scoring layout of ``n`` rows."""
        per = -(-self.n // self.shards)
        chunk = min(self.chunk, per)
        return -(-per // chunk)

    @property
    def m_dirs(self) -> int:
        return max(4 * self.hull_k, 8) + 2 * self.d

    @property
    def fixed(self) -> int:
        """The sweeps' chunk budget: the extremes' score tile (m_dirs ×
        chunk·J) with slack, under rank 0's stacked basis."""
        return max(2048, 2 * self.m_dirs * self.chunk * self.J)

    @property
    def fixed_train(self) -> int:
        """One microbatch basis of the whole batch, twice (a full-batch
        basis overflows it)."""
        return 2 * (self.n // self.mb) * self.D

    @property
    def fixed_segmented(self) -> int:
        return max(2 * self.shards * self.sketch * self.D, self.fixed)


def _fit_microbatches(n: int, chunk: int) -> int:
    """The microbatches of an adam or lbfgs fit of ``n`` rows at ``chunk``,
    as the fit's call site resolves them (``method_batch_plan``)."""
    from repro_torch.core.mctm_fit import method_batch_plan

    return method_batch_plan("adam", n, None, chunk, None)[3]


AUDIT = Shapes()
# the MCTM path of chip_smoke.py phase 3 (J = 2, degree 6, chunk 16,384) as
# rank 0 of a fake world of 8 over n = 250,001 (⌈n/chunk⌉ = 16 microbatches a
# step); k = 2,000 at α = 0.8 → 400 hull points
PHASE3 = Shapes(shards=8, chunk=16_384, cps=2, J=2, degree=6, hull_k=400, sketch=784,
                proj_q=None, mb=_fit_microbatches(250_001, 16_384), seg_chunks=1,
                n_rows=250_001)
# the programs chip_smoke.py runs at PHASE3 on the card as well
WIDTH_PROGRAMS = (
    "streamed_nll_chunk", "streamed_nll_sharded", "adam_train_step", "adam_train_step_sharded",
    "lbfgs_value_and_grad_sharded", "lbfgs_hvp_sharded", "two_pass_pass1_sharded",
    "two_pass_pass2_hull_sharded", "one_pass_sharded", "segmented_pass1_sharded",
    "segmented_onepass_sharded", "drift_nll_chunk", "drift_nll_sharded",
)


def make_programs(S: Shapes = AUDIT) -> list[ProgramSpec]:
    """The 19 programs at shapes ``S``, budgets computed from them."""
    J, D, d, chunk = S.J, S.D, S.d, S.chunk
    cps = S.rank_chunks
    q = S.proj_q if S.proj_q is not None and S.proj_q < D else None
    z_width = q if q is not None else D
    mat = MaterializationBudget(row_elems=J, fixed_elems=S.fixed)
    mat_train = MaterializationBudget(row_elems=J, fixed_elems=S.fixed_train)
    mat_seg = MaterializationBudget(row_elems=max(J, q or 0), fixed_elems=S.fixed_segmented)

    def data(dev, rows=None):
        """The host rows (for the scaler) and the first ``rows`` of them on
        the device with unit weights."""
        rows = S.n if rows is None else rows
        Y = np.random.default_rng(0).normal(size=(max(S.n, rows), J)).astype(np.float32)
        return Y, torch.as_tensor(Y[:rows], device=dev), torch.ones(rows, device=dev)

    def cfg_scaler(Y):
        from repro_torch.core.bernstein import DataScaler
        from repro_torch.core.mctm import MCTMConfig

        return MCTMConfig(J=J, degree=S.degree), DataScaler.fit(Y)

    def params(cfg, dev):
        from repro_torch.core.mctm import init_params

        return init_params(cfg, generator=torch.Generator().manual_seed(0), device=dev)

    def dirs(dev):
        from repro_torch.core.scoring import upfront_directions

        normals = np.random.default_rng(1).normal(size=(S.m_dirs - 2 * d, d))
        return torch.as_tensor(upfront_directions(d, S.hull_k, normals=normals), device=dev)

    # ------------------------------------------------------------ fit layer

    def b_streamed_nll_chunk(dev, mesh):
        from repro_torch.core.mctm_fit import _chunk_nll, fit_featurize

        Y, Yt, w = data(dev, chunk)
        cfg, scaler = cfg_scaler(Y)
        feat = fit_featurize(cfg, scaler)
        return (lambda p, y, ww: _chunk_nll(feat, cfg, p, y, ww)), (params(cfg, dev), Yt, w)

    def b_streamed_nll_sharded(dev, mesh):
        from repro_torch.core.mctm_fit import streamed_nll

        Y, Yt, w = data(dev)
        cfg, scaler = cfg_scaler(Y)
        return (lambda p, y, ww: streamed_nll(cfg, scaler, p, y, weights=ww, chunk=chunk,
                                              mesh=mesh)), (params(cfg, dev), Yt, w)

    def model_opt(Y, mb):
        from repro_torch.core.mctm_fit import MCTMDensityModel, default_fit_optimizer

        cfg, scaler = cfg_scaler(Y)
        return cfg, MCTMDensityModel(cfg, scaler, norm=float(S.n) / mb), \
            default_fit_optimizer(1e-2, 10)

    def train_batch(Yt, w, mesh, mb):
        from repro_torch.core.mctm_fit import _microbatches, _pad_batch, _rank_slice

        world = mesh.world if mesh is not None else 1
        padded = _pad_batch({"Y": Yt, "weights": w}, mb * world)[0]
        return _microbatches(_rank_slice(padded, mesh), mb)

    def b_adam(dev, mesh):
        from repro_torch.core.mctm_fit import TrainState, make_fit_step

        Y, Yt, w = data(dev)
        cfg, model, opt = model_opt(Y, S.mb)
        p0 = params(cfg, dev)
        fields = p0._fields
        p = type(p0)(*(getattr(p0, f).detach().clone().requires_grad_(True) for f in fields))
        init = opt.init([getattr(p, f) for f in fields])
        state = TrainState(0, p, {k: model.leaf_type(*v) for k, v in init.items()})
        step = make_fit_step(model, opt, fields, model.leaf_type, S.mb, device=dev, mesh=mesh)
        return step, (state, train_batch(Yt, w, mesh, S.mb))

    def lbfgs(dev, mesh):
        from repro_torch.core.mctm_fit import _pad_batch, _rank_slice, make_streamed_oracles

        Y, Yt, w = data(dev)
        cfg, model, _ = model_opt(Y, S.mb)
        p0 = params(cfg, dev)
        world = mesh.world if mesh is not None else 1
        batch = _rank_slice(_pad_batch({"Y": Yt, "weights": w}, S.mb * world)[0], mesh)
        vg, _, hvp = make_streamed_oracles(model, S.mb, mesh)
        return [getattr(p0, f) for f in p0._fields], batch, vg, hvp

    def b_lbfgs_vg(dev, mesh):
        leaves, batch, vg, _ = lbfgs(dev, mesh)
        return vg, (leaves, batch)

    def b_lbfgs_hvp(dev, mesh):
        leaves, batch, _, hvp = lbfgs(dev, mesh)
        return hvp, (leaves, [torch.zeros_like(t) for t in leaves], batch)

    # ------------------------------------------------------- scoring engine

    def engine(dev, mesh, rows=None):
        from repro_torch.core.distributed_coreset import DistributedScoringEngine

        Y, Yt, _ = data(dev, rows)
        cfg, scaler = cfg_scaler(Y)
        return DistributedScoringEngine(cfg, scaler, mesh=mesh, chunk_size=chunk), Yt

    def b_pass1(dev, mesh):
        from repro_torch.core.scoring import TwoPassExact, _Carry

        eng, Yt = engine(dev, mesh)
        sw = eng.rank_sweeps(Yt, TwoPassExact(), hull_k=S.hull_k)

        def pass1(carry):
            sw.sweep1(carry, 0, sw.n_chunks)
            return tuple(mesh.fold(carry.state))

        return pass1, (_Carry(),)

    def b_pass2(dev, mesh):
        from repro_torch.core.distributed_coreset import _extremes_cross_shard
        from repro_torch.core.scoring import TwoPassExact, RunningExtremes

        eng, Yt = engine(dev, mesh)
        sw = eng.rank_sweeps(Yt, TwoPassExact(), hull_k=S.hull_k)
        n_loc = int(sw.Y.shape[0])

        def pass2(V, inv, dirs):
            u = torch.empty(n_loc, dtype=torch.float32, device=dev)
            ext = RunningExtremes(int(dirs.shape[0]), dev)
            sw.sweep2(u, V, inv, dirs, ext, 0, sw.n_chunks)
            return u, _extremes_cross_shard(ext, mesh)

        eye = torch.eye(D, device=dev)
        return pass2, (eye, torch.ones(D, device=dev), dirs(dev))

    def onepass_carry(sw, dev, z_rows=None):
        from repro_torch.core.scoring import _Carry, RunningExtremes

        g = torch.Generator().manual_seed(2)
        n = sw.n_all
        rows = torch.randint(0, S.sketch, (n,), generator=g, dtype=torch.int32).to(dev)
        signs = (torch.randint(0, 2, (n,), generator=g) * 2 - 1).to(dev, torch.float32)
        omega = (torch.randn((D, q), generator=g) / np.sqrt(q)).to(dev) if q else None
        dd = dirs(dev)
        carry = _Carry(plan=(rows, signs, omega), state=sw.strat.init_state(D, d, dev),
                       dirs1=dd, ext=RunningExtremes(int(dd.shape[0]), dev))
        if z_rows is not None:
            carry.z_buf = torch.zeros((z_rows, z_width), dtype=torch.float32, device=dev)
        return carry

    def b_onepass(dev, mesh):
        from repro_torch.core.distributed_coreset import _extremes_cross_shard
        from repro_torch.core.scoring import OnePassSketched

        eng, Yt = engine(dev, mesh)
        sw = eng.rank_sweeps(Yt, OnePassSketched(S.sketch, proj_size=q), hull_k=S.hull_k)

        def onepass(carry):
            sw.sweep1(carry, 0, sw.n_chunks)
            state = tuple(mesh.fold(carry.state))
            return state, carry.z_blocks, _extremes_cross_shard(carry.ext, mesh)

        return onepass, (onepass_carry(sw, dev),)

    seg_rows = S.shards * 2 * S.seg_chunks * chunk  # two segments a rank

    def b_seg_pass1(dev, mesh):
        from repro_torch.core.scoring import TwoPassExact, _Carry, _moment_state

        eng, Yt = engine(dev, mesh, seg_rows)
        sw = eng.rank_sweeps(Yt, TwoPassExact(), hull_k=S.hull_k)
        G = torch.zeros((D, D), dtype=torch.float32, device=dev)

        def segment(carry):
            sw.sweep1(carry, 0, S.seg_chunks)
            return carry.state

        return segment, (_Carry(state=(G, *_moment_state(d, dev))),)

    def b_seg_onepass(dev, mesh):
        from repro_torch.core.scoring import OnePassSketched

        eng, Yt = engine(dev, mesh, seg_rows)
        sw = eng.rank_sweeps(Yt, OnePassSketched(S.sketch, proj_size=q), hull_k=S.hull_k)

        def segment(carry):
            sw.sweep1(carry, 0, S.seg_chunks)
            return carry.state, carry.z_buf, carry.ext.best_imax, carry.ext.best_imin

        return segment, (onepass_carry(sw, dev, int(sw.Y.shape[0])),)

    # ----------------------------------------------- featurize and kernels

    def b_bernstein(dev, mesh):
        from repro_torch.core.scoring import _mctm_featurize

        Y, Yt, _ = data(dev, chunk)
        cfg, scaler = cfg_scaler(Y)
        return _mctm_featurize(cfg, scaler), (Yt,)

    def kernel_inputs(dev):
        g = torch.Generator().manual_seed(5)
        X = torch.randn((chunk, D), generator=g).to(dev)
        P = torch.randn((chunk * J, d), generator=g).to(dev)
        return g, X, P

    def b_gram(dev, mesh):
        from repro_torch.kernels.gram import gram_matrix

        _, X, _ = kernel_inputs(dev)
        return gram_matrix, (X,)

    def b_extremes(dev, mesh):
        from repro_torch.kernels.extremes import directional_extremes

        _, _, P = kernel_inputs(dev)
        return directional_extremes, (P, dirs(dev))

    def b_sweep(dev, mesh):
        from repro_torch.kernels.sweep import fused_sweep_update

        g, X, P = kernel_inputs(dev)
        rows = torch.randint(0, S.sketch, (chunk,), generator=g, dtype=torch.int32).to(dev)
        signs = (torch.randint(0, 2, (chunk,), generator=g) * 2 - 1).to(dev, torch.float32)
        omega = torch.randn((D, S.proj_q or D), generator=g).to(dev)
        SX = torch.zeros((S.sketch, D), dtype=torch.float32, device=dev)
        dd = dirs(dev)
        fn = (lambda SX, X, P, sw, r, s, om: fused_sweep_update(SX, X, P, sw, r, s, dirs=dd,
                                                                 omega=om))
        return fn, (SX, X, P, torch.ones(chunk, device=dev), rows, signs, omega)

    # ------------------------------------------------------------- serving

    def slot(dev, rows):
        Y, Yt, _ = data(dev, rows)
        cfg, scaler = cfg_scaler(Y)
        b = scaler.bounds(torch.float32, dev)
        p = params(cfg, dev)
        return cfg, (p.theta_raw, p.lam), b, Yt

    def b_serve_density(dev, mesh):
        from repro_torch.core.mctm import ParamLeaves
        from repro_torch.serve.density import make_log_density_fn

        cfg, p, b, Yt = slot(dev, S.serve_bucket)
        return make_log_density_fn(cfg), (ParamLeaves(*p), b[0], b[1], b[2], Yt)

    def b_serve_sample(dev, mesh):
        from repro_torch.core.mctm import ParamLeaves
        from repro_torch.serve.density import make_conditional_sample_fn

        cfg, p, b, Yt = slot(dev, S.serve_bucket)
        g = torch.Generator().manual_seed(3)
        z = torch.randn((S.serve_bucket, J), generator=g).to(dev)
        n_obs = torch.as_tensor(np.tile(np.arange(J + 1, dtype=np.int64), S.serve_bucket)
                                [:S.serve_bucket], device=dev)
        return make_conditional_sample_fn(cfg, n_grid=S.serve_grid), \
            (ParamLeaves(*p), b[0], b[1], z, Yt, n_obs)

    # ------------------------------------------------------------- drift

    def b_drift_chunk(dev, mesh):
        from repro_torch.core.mctm_fit import fit_featurize
        from repro_torch.core.streaming import _drift_chunk

        Y, Yt, w = data(dev, chunk)
        cfg, scaler = cfg_scaler(Y)
        feat = fit_featurize(cfg, scaler)
        return (lambda p, y, ww: _drift_chunk(feat, cfg, p, y, ww)), (params(cfg, dev), Yt, w)

    def b_drift_sharded(dev, mesh):
        from repro_torch.core.streaming import drift_window_nll

        Y, Yt, w = data(dev)
        cfg, scaler = cfg_scaler(Y)
        return (lambda p, y, ww: drift_window_nll(cfg, scaler, p, y, ww, chunk=chunk,
                                                  mesh=mesh)), (params(cfg, dev), Yt, w)

    serve_fixed = max(S.serve_grid * D, S.fixed)
    basic = ("MAT-CHUNK", "DTYPE-F32", "HOST-FREE")
    return [
        ProgramSpec(
            name="streamed_nll_chunk",
            description="streamed_nll's body: featurize → nll_terms on one (chunk, J) block "
                        "(mctm_fit._chunk_nll)",
            build=b_streamed_nll_chunk, materialization=mat,
            kernels=(("bernstein", 1),), invariants=basic),
        ProgramSpec(
            name="streamed_nll_sharded",
            description="the (1±ε) evaluator on rank 0: its chunks, the float64 total on the "
                        "device, ONE fold, one read of the result (mctm_fit.streamed_nll)",
            build=b_streamed_nll_sharded, collectives=CollectiveBudget(fold=1),
            materialization=mat, host_reads=1, kernels=(("bernstein", cps),),
            needs_world=S.shards, invariants=("COLL-ONE-PSUM", "MAT-CHUNK", "DTYPE-F32",
                                              "HOST-FREE")),
        ProgramSpec(
            name="adam_train_step",
            description="the adam fit's microbatched step (mctm_fit.make_fit_step): params "
                        "updated in place, moments new",
            build=b_adam, materialization=mat_train, inplace_state=2,
            kernels=(("bernstein", S.mb),),
            invariants=("MAT-CHUNK", "DTYPE-F32", "DONATE-STATE", "HOST-FREE")),
        ProgramSpec(
            name="adam_train_step_sharded",
            description="the same step on rank 0 of the mesh: its rows, loss and gradients "
                        "in ONE fold",
            build=b_adam, collectives=CollectiveBudget(fold=1, exact=False),
            materialization=mat_train, inplace_state=2, kernels=(("bernstein", S.mb),),
            needs_world=S.shards,
            invariants=("COLL-CEILING", "MAT-CHUNK", "DTYPE-F32", "DONATE-STATE",
                        "HOST-FREE")),
        ProgramSpec(
            name="lbfgs_value_and_grad_sharded",
            description="the streaming L-BFGS value-and-grad oracle on rank 0, ONE fold "
                        "(mctm_fit.make_streamed_oracles)",
            build=b_lbfgs_vg, collectives=CollectiveBudget(fold=1, exact=False),
            materialization=mat_train, kernels=(("bernstein", S.mb),), needs_world=S.shards,
            invariants=("COLL-CEILING", "MAT-CHUNK", "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="lbfgs_hvp_sharded",
            description="the streaming L-BFGS HVP oracle (jvp of grad on each microbatch's "
                        "features), ONE fold",
            build=b_lbfgs_hvp, collectives=CollectiveBudget(fold=1, exact=False),
            materialization=mat_train, kernels=(("bernstein", S.mb),), needs_world=S.shards,
            invariants=("COLL-CEILING", "MAT-CHUNK", "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="two_pass_pass1_sharded",
            description="TwoPassExact sweep 1 on rank 0 (DistributedScoringEngine): "
                        "(G, Σp, Σppᵀ) over its chunks, ONE fold",
            build=b_pass1, collectives=CollectiveBudget(fold=1), materialization=mat,
            kernels=(("bernstein", cps), ("gram", cps)), needs_world=S.shards,
            invariants=("COLL-ONE-PSUM", "MAT-CHUNK", "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="two_pass_pass2_hull_sharded",
            description="TwoPassExact sweep 2 on rank 0: leverage and the running extremes "
                        "on the device, then exactly one gather pair",
            build=b_pass2, collectives=CollectiveBudget(hull_gather=2), materialization=mat,
            kernels=(("bernstein", cps), ("extremes", cps)), needs_world=S.shards,
            invariants=("COLL-HULL-GATHER", "MAT-CHUNK", "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="one_pass_sharded",
            description="OnePassSketched's sweep on rank 0: sketch, z and extremes in one "
                        "sweep launch a chunk, ONE fold, one gather pair",
            build=b_onepass, collectives=CollectiveBudget(fold=1, hull_gather=2),
            materialization=MaterializationBudget(row_elems=max(J, q or 0),
                                                  fixed_elems=S.fixed),
            kernels=(("bernstein", cps), ("sweep", cps)), needs_world=S.shards,
            invariants=("COLL-ONE-PSUM", "COLL-HULL-GATHER", "SWEEP-FUSED", "MAT-CHUNK",
                        "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="segmented_pass1_sharded",
            description="one segment of the resumable sweep 1 (the sweep_ckpt= path) on rank "
                        "0: the carry goes to the checkpoint, ZERO collectives",
            build=b_seg_pass1, materialization=mat_seg,
            kernels=(("bernstein", S.seg_chunks), ("gram", S.seg_chunks)),
            needs_world=S.shards,
            invariants=("COLL-SEG-NONE", "MAT-CHUNK", "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="segmented_onepass_sharded",
            description="one segment of the resumable one-pass sweep: sketch, z buffer and "
                        "device extremes carried, ZERO collectives",
            build=b_seg_onepass, materialization=mat_seg,
            kernels=(("bernstein", S.seg_chunks), ("sweep", S.seg_chunks)),
            needs_world=S.shards,
            invariants=("COLL-SEG-NONE", "SWEEP-FUSED", "MAT-CHUNK", "DTYPE-F32",
                        "HOST-FREE")),
        ProgramSpec(
            name="bernstein_featurize",
            description="the fused featurize of one chunk (scoring._mctm_featurize, shared by "
                        "the scoring and fit paths)",
            build=b_bernstein, materialization=mat, kernels=(("bernstein", 1),),
            invariants=basic),
        ProgramSpec(
            name="gram_kernel",
            description="the gram kernel's wrapper on one (chunk, D) block",
            build=b_gram, materialization=mat, kernels=(("gram", 1),), invariants=basic),
        ProgramSpec(
            name="extremes_kernel",
            description="the directional-extremes kernel's wrapper on one chunk's P rows",
            build=b_extremes, materialization=mat, kernels=(("extremes", 1),),
            invariants=basic),
        ProgramSpec(
            name="serve_log_density_bucket",
            description="DensityServeEngine's log-density function for one padded bucket "
                        "(serve.density.make_log_density_fn)",
            build=b_serve_density, materialization=mat, kernels=(("bernstein", 1),),
            invariants=basic),
        ProgramSpec(
            name="serve_conditional_sample_bucket",
            description="DensityServeEngine's conditional sampler for one bucket: the "
                        "(grid, J, d) inversion basis is fixed state, nothing scales past the "
                        "bucket (serve.density.make_conditional_sample_fn)",
            build=b_serve_sample, materialization=MaterializationBudget(
                row_elems=J, fixed_elems=serve_fixed),
            kernels=(("bernstein", 2),), invariants=basic),
        ProgramSpec(
            name="drift_nll_chunk",
            description="drift_window_nll's body: the (Σw·nll, Σw) pair of one block "
                        "(streaming._drift_chunk)",
            build=b_drift_chunk, materialization=mat, kernels=(("bernstein", 1),),
            invariants=basic),
        ProgramSpec(
            name="drift_nll_sharded",
            description="the drift window's NLL on rank 0: float64 totals on the device, ONE "
                        "fold of the pair, one read of the ratio (streaming.drift_window_nll)",
            build=b_drift_sharded, collectives=CollectiveBudget(fold=1), materialization=mat,
            host_reads=1, kernels=(("bernstein", cps),), needs_world=S.shards,
            invariants=("COLL-ONE-PSUM", "MAT-CHUNK", "DTYPE-F32", "HOST-FREE")),
        ProgramSpec(
            name="sweep_kernel",
            description="the fused one-pass sweep kernel's wrapper: sketch, z and extremes of "
                        "one chunk in one launch (kernels.sweep)",
            build=b_sweep, materialization=MaterializationBudget(row_elems=J,
                                                                 fixed_elems=S.fixed),
            kernels=(("sweep", 1),), invariants=("SWEEP-FUSED", "MAT-CHUNK", "DTYPE-F32",
                                                  "HOST-FREE")),
    ]


for _spec in make_programs(AUDIT):
    register(_spec)
