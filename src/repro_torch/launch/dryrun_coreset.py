"""Dry run of the paper's technique at pod scale — the port of
``repro.launch.dryrun_coreset``: Algorithm 1's coreset scoring (leverage)
of n = 4.2M rows of Bernstein features on the reference's production
meshes, rank 0's program traced, never executed. Four variants:

  naive   — gather the whole feature matrix to every rank, then the Gram and
            the scores (a straight port of the single-node algorithm): one
            ``row_gather`` of X
  psum    — each rank's Gram on the gram kernel, ONE fold of it, local
            projections (``distributed_coreset.distributed_leverage``'s
            structure; the reference's variant does not lower, see below)
  sketch  — ``DistributedScoringEngine``'s one-pass sketched sweep
            (``OnePassSketched`` on raw feature rows): the CountSketch over
            the rank's chunks on the sweep kernel, ONE fold of SX, leverage
            read off the retained rows
  engine  — ``DistributedScoringEngine``'s two-pass structure: sweep 1 over
            the rank's chunks (the gram kernel), ONE fold of G, sweep 2's
            chunked leverage

The production mesh is rank 0 of a fake world (``launch.mesh.
make_production_mesh``: 16 data shards for 16×16, 32 for 2×16×16; the
model axis is not carried), and the program runs under ``FakeTensorMode``:
the rank's shard is allocated nowhere, every kernel wrapper takes its plain
version on the fake CPU tensors, and every collective is counted by the
mesh's census as a real one would be. The dry run is CPU-only by nature,
as the reference's is on placeholder devices: nothing in it runs on the
card.

Each record holds the rank's FLOPs (``torch.utils.flop_counter.
FlopCounterMode``: matmul-family ops only — elementwise work and eigh are
not counted), the bytes its ops read and write (the auditor's dispatch
trace, ``analysis.checks.OpTrace``: each non-view op's inputs and outputs),
its collectives and their bytes (``DataMesh.census``: a fold gathers every
rank's partials, so its bytes are world × the state's), and the roofline
terms of ``launch/roofline.py`` at the f32 rate the port's kernels compute
at. The (D, D) projection runs in torch on the fake Gram (an eigh in the
program, as the reference's ``gram_projection`` is in-graph): the port's
scoring engine factors its Gram with a host float64 eigh, which has no
values to read here.

The reference's ``psum`` variant passes the function ``data_axes`` where
its ``shard_map`` spec wants the axes, and does not lower; this variant has
no reference figures.

    python -m repro_torch.launch.dryrun_coreset              # 4 variants × 2 meshes
    python -m repro_torch.launch.dryrun_coreset --multi-pod  # 2×16×16 only

Writes ``results/dryrun/torch_coreset__score__<mesh>__opt-<variant>.json``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.launch.roofline import F32_FLOPS, HBM_BW, ICI_BW, roofline_terms

RESULTS_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "..", "..", "..", "results", "dryrun"))
VARIANTS = ("naive", "psum", "sketch", "engine")
MESHES = {"16x16": False, "2x16x16": True}
DEVICE = torch.device("cpu")  # fake tensors on the CPU: the dry run never runs on a device
CHUNK = 4096  # the engine's and the sketch's sweep chunk (rows)

__all__ = ["score_fn", "run", "main", "VARIANTS", "MESHES"]


def _projection(G: torch.Tensor, rcond: float = 1e-6):
    """(V, inv) with u_i = Σ_m (X_i V)²_m · inv_m, in torch (the
    reference's in-graph ``gram_projection``; the pseudo-inverse's)."""
    w, V = torch.linalg.eigh(G)
    wmax = torch.max(torch.abs(w))
    inv = torch.where(w > rcond * wmax, 1.0 / torch.clamp(w, min=1e-30), torch.zeros_like(w))
    return V, inv


def _leverage(X: torch.Tensor, V: torch.Tensor, inv: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(X @ V) * inv, dim=1)


def score_fn(variant: str, mesh, n: int, D: int, sketch: int = 0):
    """Rank 0's program: ``(fn, args)``, its inputs fake tensors of the
    rank's shard (to be called under ``FakeTensorMode``)."""
    from repro_torch.kernels.gram import gram_matrix

    shards = mesh.world
    per = n // shards
    if n % shards:
        raise ValueError(f"dry-run shapes: n = {n} is no multiple of the {shards} data shards")
    X = torch.empty((per, D), dtype=torch.float32, device=DEVICE)

    if variant == "naive":

        def fn(X):
            # straight port: every rank gathers X, then the Gram and the scores
            Xr = mesh.all_gather(X, "row_gather").reshape(n, D)
            V, inv = _projection(Xr.T @ Xr)
            return _leverage(Xr, V, inv) + 1.0 / n

        return fn, (X,)

    if variant == "psum":

        def fn(X):
            G = mesh.fold([gram_matrix(X)])[0]
            V, inv = _projection(G)
            return _leverage(X, V, inv) + 1.0 / n

        return fn, (X,)

    from repro_torch.core.distributed_coreset import DistributedScoringEngine, StagedRows
    from repro_torch.core.scoring import OnePassSketched, TwoPassExact, _Carry, _z_leverage

    chunk = min(CHUNK, per)
    if per % chunk:
        raise ValueError("dry-run shapes: per-shard rows % chunk must be 0")
    eng = DistributedScoringEngine(featurize=lambda x: (x, None), mesh=mesh, axis=mesh.axes,
                                   chunk_size=chunk, rows_per_point=1)
    staged = StagedRows(X, n, 0, X[:1])

    if variant == "sketch":
        strat = OnePassSketched(sketch)
        sw = eng.rank_sweeps(staged, strat)
        rows = torch.empty(n, dtype=torch.int32, device=DEVICE)
        signs = torch.empty(n, dtype=torch.float32, device=DEVICE)
        carry = _Carry(plan=(rows, signs, None), state=strat.init_state(D, None, DEVICE))

        def fn(carry):
            sw.sweep1(carry, 0, sw.n_chunks)
            SX = mesh.fold(carry.state)[0]
            V, inv = _projection(SX.T @ SX)
            return torch.cat([_z_leverage(z, V, inv) for z in carry.z_blocks]) + 1.0 / n

        return fn, (carry,)

    if variant == "engine":
        sw = eng.rank_sweeps(staged, TwoPassExact())

        def fn(carry):
            sw.sweep1(carry, 0, sw.n_chunks)
            G = mesh.fold(carry.state)[0]
            V, inv = _projection(G)
            u = torch.empty(per, dtype=torch.float32, device=DEVICE)
            sw.sweep2(u, V, inv, None, None, 0, sw.n_chunks)
            return u + 1.0 / n

        return fn, (_Carry(),)

    raise ValueError(f"unknown dry-run variant {variant!r} (one of {VARIANTS})")


def run(variant: str, multi_pod: bool, n: int, J: int, d: int, out_dir: str | None) -> dict:
    """Trace one variant on one production mesh; write and return its record."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.analysis.checks import trace_program
    from repro_torch.launch.mesh import make_production_mesh

    D = J * d
    t0 = time.perf_counter()
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        with FakeTensorMode():
            fn, args = score_fn(variant, mesh, n, D, sketch=4 * D)
            flops = FlopCounterMode(display=False)
            with flops:
                out, trace, reads, kernels, (calls, cbytes) = trace_program(
                    fn, args, card=False, mesh=mesh)
            out_shape = list(out.shape)
        census = {k: dict(v) for k, v in mesh.census.items() if isinstance(v, dict)}
    finally:
        mesh.close()
    name = "2x16x16" if multi_pod else "16x16"
    total_flops = float(flops.get_total_flops())
    terms = roofline_terms(
        arch="coreset-score", shape=f"n{n}_J{J}_d{d}", mesh_name=name, chips=mesh.chips,
        hlo_flops=total_flops, hlo_bytes=float(trace.bytes), collective_bytes=float(cbytes),
        collective_by_op=census, model_flops=total_flops, analytic=0.0,
        peak_flops=F32_FLOPS,
        note="rank 0 traced under FakeTensorMode; FLOPs count matmul-family ops only")
    rec = {
        "arch": "coreset-score",
        "shape": terms.shape,
        "mesh": name,
        "chips": mesh.chips,
        "data_shards": mesh.world,
        "variant": variant,
        "flops": total_flops,
        "bytes": float(trace.bytes),
        "collective_bytes": float(cbytes),
        "collectives": {k: v for k, v in calls.items() if v},
        "collective_by_op": census,
        "kernels": kernels,
        "host_reads": len(reads),
        "max_intermediate_elems": trace.max_elems,
        "output_shape": out_shape,
        "peak_flops": F32_FLOPS,
        "hbm_bw": HBM_BW,
        "link_bw": ICI_BW,
        "compute_s": terms.compute_s,
        "memory_s": terms.memory_s,
        "collective_s": terms.collective_s,
        "dominant": terms.dominant + "_s",
        "trace_seconds": time.perf_counter() - t0,
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"torch_coreset__score__{name}__opt-{variant}"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(rec, f, indent=1)
    print(f"[done] {name} {variant}: compute={rec['compute_s']:.6g}s "
          f"mem={rec['memory_s']:.6g}s coll={rec['collective_s']:.6g}s "
          f"dom={rec['dominant']} ({rec['trace_seconds']:.1f}s to trace)", flush=True)
    return rec


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", default="all", choices=VARIANTS + ("all",))
    ap.add_argument("--multi-pod", action="store_true",
                    help="the 2×16×16 mesh only (both meshes without it)")
    ap.add_argument("--n", type=int, default=4_194_304)
    ap.add_argument("--J", type=int, default=20)
    ap.add_argument("--d", type=int, default=7)
    ap.add_argument("--out", default=RESULTS_DIR)
    args = ap.parse_args(argv)
    meshes = ["2x16x16"] if args.multi_pod else list(MESHES)
    variants = VARIANTS if args.variant == "all" else (args.variant,)
    return [run(v, MESHES[m], args.n, args.J, args.d, args.out)
            for m in meshes for v in variants]


if __name__ == "__main__":
    main()
