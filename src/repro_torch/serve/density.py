"""Continuous-batching density-serving engine over a fitted MCTM — the port
of ``repro.serve.density`` (contract: ``docs/SERVING.md``).

* **Static shapes under ragged traffic.** Queued requests are coalesced into
  padded batch buckets (powers of two from ``min_bucket`` up to
  ``max_batch``), and each (query kind, bucket) has one executable, built
  once: on the card a CUDA graph captured over static input buffers (the
  counterpart of jax's executable cache), on the CPU the eager function over
  the same buffers. ``warmup()`` builds the whole ladder; steady traffic and
  publishes never build again, and ``compile_count`` (the capture meter)
  says so. Every capture happens in ``warmup()`` or a first dispatch, on the
  serving thread, with ``capture_error_mode="thread_local"``, so a refit
  thread's kernels do not break it.
* **Params are graph inputs.** The model lives in static parameter and
  scaler buffers that every graph reads. ``publish()`` (any thread) stages
  an immutable ``ModelSlot``; the tick's start swaps it in and ``copy_``s it
  into the static buffers (after the event recorded when the slot was
  built), then reads the slot once: every query of a tick, and so every
  query, is answered by exactly one version, and none is dropped. A swap
  costs no capture: shapes and dtypes are fixed by the config.
* **The kernels inside a graph.** ``log_density`` featurizes through the
  bernstein kernel (the scaler transform, clip and ``inv_span`` scale of
  ``mctm.log_density``), and so does the sampler (its inversion grid and
  the observed prefix). A replay runs no Python, so a wrapper's launch
  count does not move: the engine counts ``replayed_launches`` (replays ×
  the kernels each graph holds) instead.

Query kinds: ``log_density`` (log p(y), ``mctm.log_density``) and
``sample`` (conditional sampling: observe ``y[:n_obs]``, draw the rest by
the triangular recursion of ``mctm.sample`` made conditional). A sample
row's normals are a pure function of (the engine's ``sample_seed``, the
request's seed), drawn on the host per row and written into the graph's
static buffer, so coalesced and per-request answers agree exactly; torch
cannot replay the reference's ``fold_in`` draws, so ``submit_sample``
takes them as ``normals=`` (parity tests).

``refit_and_publish`` (coreset build → streamed fit → publish) runs the
refit on its own CUDA stream and publishes only after an event recorded on
that stream has completed; ``start_background_refit`` runs it on a daemon
thread, one in flight at a time.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.core import mctm as M
from repro_torch.core.bernstein import monotone_theta
from repro_torch.device import resolve_device, to_tensor
from repro_torch.kernels.bernstein import bernstein_featurize
from repro_torch.kernels.bernstein import ops as bernstein_ops

__all__ = [
    "QUERY_KINDS",
    "DensityRequest",
    "ModelSlot",
    "DensityServeEngine",
    "bucket_sizes",
    "bucket_for",
    "make_log_density_fn",
    "make_conditional_sample_fn",
    "refit_and_publish",
    "start_background_refit",
]

QUERY_KINDS = ("log_density", "sample")


# ---------------------------------------------------------------------------
# batched query functions (params and scaler as arguments: a swap rebuilds
# nothing, and every step is capturable: no host reads, no host copies)
# ---------------------------------------------------------------------------


def make_log_density_fn(cfg: M.MCTMConfig) -> Callable:
    """Batched ``log p(y)``: ``fn(params, low, high, inv_span, Y)`` → (B,).

    The scaler arrays are arguments (a refit may publish a new scaler), and
    ``inv_span`` arrives precomputed, as ``DataScaler.bounds`` casts it: the
    answer has the bits of ``mctm.log_density`` on the same rows."""

    def log_density_fn(params, low, high, inv_span, Y):
        A, Ap = bernstein_featurize(Y, torch.stack([low, high, inv_span]), cfg.degree)
        return -M.nll_terms(cfg, params, A, Ap)

    return log_density_fn


def make_conditional_sample_fn(cfg: M.MCTMConfig, n_grid: int = 512) -> Callable:
    """Batched conditional sampler: ``fn(params, low, high, z, y_obs, n_obs)``
    → (B, J), z (B, J) the rows' standard normals.

    Row i observes ``y_obs[i, :n_obs[i]]`` and samples the remaining
    dimensions (``n_obs[i] = 0`` → a full draw; ``n_obs[i] = J`` → the row
    unchanged, the padding convention). The triangular recursion h̃_j = z_j
    − Σ_{l<j} λ_{jl} h̃_l runs over realized h̃ values (observed dimensions
    contribute their Bernstein transform, sampled ones the value the
    recursion just produced), and sampled marginals invert on the same
    ``n_grid`` grid as ``mctm.sample``; the grid's basis and the observed
    prefix's are featurized on the bernstein kernel."""

    def sample_fn(params, low, high, z, y_obs, n_obs):
        J = cfg.J
        theta = monotone_theta(params.theta_raw, cfg.min_slope)          # (J, d)
        Lam = M.lambda_matrix(cfg, params.lam)
        t_grid = torch.linspace(0.0, 1.0, n_grid, dtype=torch.float32, device=z.device)
        unit = torch.stack([torch.zeros_like(low), torch.ones_like(low), torch.ones_like(low)])
        Ag, _ = bernstein_featurize(t_grid[:, None].expand(n_grid, J).contiguous(), unit,
                                    cfg.degree)
        grid_vals = torch.einsum("gjd,jd->gj", Ag, theta)                # (G, J)
        span = high - low
        Ao, _ = bernstein_featurize(y_obs, torch.stack([low, high, 1.0 / span]), cfg.degree)
        h_obs = torch.einsum("njd,jd->nj", Ao, theta)
        observed = torch.arange(J, dtype=n_obs.dtype, device=z.device)[None, :] < n_obs[:, None]
        h_cols: list = []
        y_cols: list = []
        for j in range(J):  # J is small and static: unrolled
            target = z[:, j]
            for l in range(j):
                target = target - Lam[j, l] * h_cols[l]
            col = grid_vals[:, j].contiguous()
            idx = torch.clamp(torch.searchsorted(col, target.contiguous()), 1, n_grid - 1)
            v0, v1 = col[idx - 1], col[idx]
            t0, t1 = t_grid[idx - 1], t_grid[idx]
            frac = torch.clamp((target - v0) / torch.clamp(v1 - v0, min=1e-12), 0.0, 1.0)
            y_samp = low[j] + (t0 + frac * (t1 - t0)) * span[j]
            h_cols.append(torch.where(observed[:, j], h_obs[:, j], target))
            y_cols.append(torch.where(observed[:, j], y_obs[:, j], y_samp))
        return torch.stack(y_cols, dim=1)

    return sample_fn


def row_normals(sample_seed: int, seed: int, J: int) -> np.ndarray:
    """A sample request's (J,) standard normals: a pure function of the
    engine's seed and the request's, whatever bucket the row lands in."""
    mask = (1 << 64) - 1
    rng = np.random.default_rng([int(sample_seed) & mask, int(seed) & mask])
    return rng.standard_normal(J).astype(np.float32)


# ---------------------------------------------------------------------------
# requests, model slot, bucket policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DensityRequest:
    """One density query. ``kind`` is ``"log_density"`` (evaluate at ``y``)
    or ``"sample"`` (observe ``y[:n_obs]``, draw the rest with ``seed``, or
    with the given ``normals``)."""

    uid: int
    kind: str
    y: np.ndarray                      # (J,) float32
    n_obs: int = 0                     # sample: observed prefix length
    seed: int = 0                      # sample: per-request randomness
    normals: np.ndarray | None = None  # sample: (J,) draws in place of the seed's
    # filled by the engine:
    result: np.ndarray | float | None = None
    version: int = -1                  # model version that served it
    submitted_s: float = 0.0
    finished_s: float = 0.0

    @property
    def done(self) -> bool:
        return self.finished_s > 0

    @property
    def latency_s(self) -> float:
        return self.finished_s - self.submitted_s


class ModelSlot(NamedTuple):
    """One published model: immutable, swapped whole (double buffering).
    ``ready`` is the CUDA event recorded after its tensors were written
    (None on the CPU)."""

    version: int
    params: M.MCTMParams
    low: torch.Tensor       # (J,) f32 scaler bounds
    high: torch.Tensor
    inv_span: torch.Tensor  # (J,) f32, as DataScaler.bounds casts it
    ready: object = None


def bucket_sizes(min_bucket: int, max_batch: int) -> tuple[int, ...]:
    """The bucket ladder: powers of two from ``min_bucket``, capped at (and
    always including) ``max_batch``."""
    sizes = []
    b = max(1, int(min_bucket))
    while b < max_batch:
        sizes.append(b)
        b *= 2
    sizes.append(int(max_batch))
    return tuple(sizes)


def bucket_for(m: int, sizes: tuple[int, ...]) -> int:
    """Smallest bucket holding ``m`` rows (``m`` ≤ max(sizes) by admission)."""
    for b in sizes:
        if m <= b:
            return b
    return sizes[-1]


def _slot_from(version: int, params, scaler, device: torch.device) -> ModelSlot:
    f32 = dict(dtype=torch.float32, device=device)
    slot = ModelSlot(
        version=version,
        params=M.MCTMParams(*(to_tensor(getattr(params, f), **f32).detach().clone()
                              for f in ("theta_raw", "lam"))),
        low=torch.as_tensor(np.asarray(scaler.low, np.float64), device=device).to(torch.float32),
        high=torch.as_tensor(np.asarray(scaler.high, np.float64), device=device).to(torch.float32),
        inv_span=torch.as_tensor(np.asarray(scaler.inv_span, np.float64),
                                 device=device).to(torch.float32),
    )
    if device.type == "cuda":
        ready = torch.cuda.Event()
        ready.record()
        slot = slot._replace(ready=ready)
    return slot


@dataclasses.dataclass
class _Exec:
    """One (kind, bucket) executable: static inputs, static output, and
    ``run`` (a graph replay on the card, the eager function on the CPU)."""

    inputs: dict
    out: torch.Tensor
    run: Callable[[], None]
    kernels: dict  # kernel launches one run makes, by kernel


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class DensityServeEngine:
    """Continuous-batching server for ``log_density`` / conditional
    ``sample`` queries over a fitted MCTM (module doc for the contract).

    One ``step()`` = one tick: swap in any staged model, then for each query
    kind coalesce up to ``max_batch`` queued requests into their padded
    bucket and run its executable. ``publish()`` may be called from any
    thread (the background refit worker); it never blocks serving.
    ``device`` None → CUDA, which must exist.
    """

    def __init__(
        self,
        cfg: M.MCTMConfig,
        params,
        scaler,
        *,
        max_batch: int = 256,
        min_bucket: int = 8,
        n_grid: int = 512,
        sample_seed: int = 0,
        device=None,
    ):
        if max_batch < 1 or min_bucket < 1:
            raise ValueError("max_batch and min_bucket must be ≥ 1")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.max_batch = int(max_batch)
        self.buckets = bucket_sizes(min_bucket, max_batch)
        self.n_grid = int(n_grid)
        self.sample_seed = int(sample_seed)
        self._slot = _slot_from(0, params, scaler, self.device)
        self._staged: ModelSlot | None = None
        self._lock = threading.Lock()
        self._version = 0
        self.queues: dict[str, deque[DensityRequest]] = {k: deque() for k in QUERY_KINDS}
        self._uid = 0
        # the capture meter: one count per executable built (a CUDA graph
        # capture on the card); steady traffic keeps it frozen
        self.trace_counts = {k: 0 for k in QUERY_KINDS}
        self._fns = {"log_density": make_log_density_fn(cfg),
                     "sample": make_conditional_sample_fn(cfg, self.n_grid)}
        # the static model buffers every executable reads (graph inputs)
        s = self._slot
        self._static = {"theta_raw": s.params.theta_raw.clone(), "lam": s.params.lam.clone(),
                        "low": s.low.clone(), "high": s.high.clone(),
                        "inv_span": s.inv_span.clone()}
        self._loaded = 0
        self._execs: dict[tuple[str, int], _Exec] = {}
        self.replayed_launches: dict[str, int] = {}
        self.ticks = 0
        self.served = {k: 0 for k in QUERY_KINDS}
        self.bucket_counts: dict[tuple[str, int], int] = {}
        self.swap_events: list[dict] = []
        self.tick_times: list[float] = []
        # one record per refit_and_publish cycle (version, fit NLL per
        # weighted coreset point: the drift detector's anchor) and the one
        # background refit thread in flight
        self.refit_log: list[dict] = []
        self._refit_thread: threading.Thread | None = None

    # ------------------------------------------------------------ properties

    @property
    def compile_count(self) -> int:
        """Executables built across both query kinds (the capture meter)."""
        return sum(self.trace_counts.values())

    @property
    def version(self) -> int:
        return self._slot.version

    @property
    def refit_in_flight(self) -> bool:
        th = self._refit_thread
        return th is not None and th.is_alive()

    def current_slot(self) -> ModelSlot:
        """The live model slot (params, scaler bounds, version): what a drift
        evaluator scores incoming windows against."""
        return self._slot

    def start_background_refit(self, *args, **kwargs):
        """``refit_and_publish`` on a daemon thread, one in flight: a second
        trigger while one runs is a no-op returning None. Returns the
        started thread otherwise."""
        if self.refit_in_flight:
            return None
        th = threading.Thread(target=refit_and_publish, args=(self, *args), kwargs=kwargs,
                              daemon=True)
        self._refit_thread = th
        th.start()
        return th

    # -------------------------------------------------------------- admission

    def submit(self, req: DensityRequest) -> DensityRequest:
        if req.kind not in QUERY_KINDS:
            raise ValueError(f"unknown query kind {req.kind!r}")
        req.submitted_s = time.perf_counter()
        self.queues[req.kind].append(req)
        return req

    def _next_uid(self) -> int:
        self._uid += 1
        return self._uid

    def submit_log_density(self, Y) -> list[DensityRequest]:
        """Queue one ``log_density`` request per row of ``Y`` (n, J)."""
        Y = np.atleast_2d(np.asarray(Y, np.float32))
        return [self.submit(DensityRequest(self._next_uid(), "log_density", y)) for y in Y]

    def submit_sample(self, n: int = 1, *, seeds=None, y_obs=None, n_obs: int = 0,
                      normals=None) -> list[DensityRequest]:
        """Queue ``n`` conditional-sample requests. ``y_obs`` is one (J,)
        observed row shared by the batch (or (n, J) rows); ``n_obs`` its
        observed prefix length; ``seeds`` per-request ints (default:
        sequential from the running uid); ``normals`` (n, J) the rows' draws
        in place of the seeds' (the reference's, in parity tests)."""
        J = self.cfg.J
        if y_obs is None:
            y_obs = np.zeros((n, J), np.float32)
        else:
            y_obs = np.broadcast_to(np.atleast_2d(np.asarray(y_obs, np.float32)), (n, J)).copy()
        if seeds is None:
            seeds = [self._uid + 1 + i for i in range(n)]
        if normals is not None:
            normals = np.asarray(normals, np.float32).reshape(n, J)
        return [
            self.submit(DensityRequest(
                self._next_uid(), "sample", y_obs[i], n_obs=int(n_obs), seed=int(seeds[i]),
                normals=None if normals is None else normals[i]))
            for i in range(n)
        ]

    # -------------------------------------------------------------- execution

    def _params(self) -> M.ParamLeaves:
        return M.ParamLeaves(self._static["theta_raw"], self._static["lam"])

    def _build(self, kind: str, bucket: int) -> _Exec:
        """The (kind, bucket) executable over fresh static inputs: captured
        as a CUDA graph on the card (two eager runs first, on a side stream,
        as capture requires), the eager function on the CPU."""
        J, dev = self.cfg.J, self.device
        st = self._static
        f32 = dict(dtype=torch.float32, device=dev)
        if kind == "log_density":
            inputs = {"Y": torch.zeros((bucket, J), **f32)}

            def call():
                return self._fns[kind](self._params(), st["low"], st["high"], st["inv_span"],
                                       inputs["Y"])
        else:
            inputs = {"z": torch.zeros((bucket, J), **f32),
                      "y_obs": torch.zeros((bucket, J), **f32),
                      "n_obs": torch.full((bucket,), J, dtype=torch.int32, device=dev)}

            def call():
                return self._fns[kind](self._params(), st["low"], st["high"], inputs["z"],
                                       inputs["y_obs"], inputs["n_obs"])

        self.trace_counts[kind] += 1
        if dev.type != "cuda":
            before = bernstein_ops.LAUNCHES
            with torch.no_grad():
                out = call()
            kernels = {"bernstein": bernstein_ops.LAUNCHES - before}

            def run():
                with torch.no_grad():
                    out.copy_(call())

            return _Exec(inputs, out, run, kernels)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.no_grad(), torch.cuda.stream(side):
            for _ in range(2):
                call()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = bernstein_ops.LAUNCHES
        with torch.no_grad(), torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = call()
        kernels = {"bernstein": bernstein_ops.LAUNCHES - before}
        return _Exec(inputs, out, graph.replay, kernels)

    def _get_exec(self, kind: str, bucket: int) -> _Exec:
        ex = self._execs.get((kind, bucket))
        if ex is None:
            ex = self._execs[(kind, bucket)] = self._build(kind, bucket)
        return ex

    def _load(self, slot: ModelSlot) -> None:
        """Copy the slot into the static buffers, once per version: after
        the event that recorded its tensors, on the serving stream."""
        if self._loaded == slot.version:
            return
        if slot.ready is not None:
            torch.cuda.current_stream(self.device).wait_event(slot.ready)
        st = self._static
        with torch.no_grad():
            st["theta_raw"].copy_(slot.params.theta_raw)
            st["lam"].copy_(slot.params.lam)
            st["low"].copy_(slot.low)
            st["high"].copy_(slot.high)
            st["inv_span"].copy_(slot.inv_span)
        self._loaded = slot.version

    def _dispatch(self, slot: ModelSlot, kind: str, reqs: list[DensityRequest]):
        m = len(reqs)
        bucket = bucket_for(m, self.buckets)
        self.bucket_counts[(kind, bucket)] = self.bucket_counts.get((kind, bucket), 0) + 1
        ex = self._get_exec(kind, bucket)
        J = self.cfg.J
        Y = np.empty((bucket, J), np.float32)
        for i, r in enumerate(reqs):
            Y[i] = r.y
        # pad with valid row-0 copies: real data through the featurize,
        # results sliced away
        Y[m:] = Y[0]
        if kind == "log_density":
            ex.inputs["Y"].copy_(torch.from_numpy(Y))
        else:
            n_obs = np.full(bucket, J, np.int32)  # pad: fully observed
            z = np.zeros((bucket, J), np.float32)
            for i, r in enumerate(reqs):
                n_obs[i] = r.n_obs
                z[i] = r.normals if r.normals is not None else row_normals(
                    self.sample_seed, r.seed, J)
            ex.inputs["y_obs"].copy_(torch.from_numpy(Y))
            ex.inputs["n_obs"].copy_(torch.from_numpy(n_obs))
            ex.inputs["z"].copy_(torch.from_numpy(z))
        ex.run()
        for name, count in ex.kernels.items():
            self.replayed_launches[name] = self.replayed_launches.get(name, 0) + count
        out = ex.out[:m].cpu().numpy().copy()  # the static output is rewritten next run
        now = time.perf_counter()
        for i, r in enumerate(reqs):
            r.result = float(out[i]) if kind == "log_density" else out[i]
            r.version = slot.version
            r.finished_s = now
        self.served[kind] += m

    def step(self) -> int:
        """One tick: swap in a staged model, serve ≤ one bucket per kind.
        Returns the number of requests completed this tick."""
        t0 = time.perf_counter()
        with self._lock:
            if self._staged is not None:
                self._slot = self._staged
                self._staged = None
                self.swap_events[-1]["visible_s"] = time.perf_counter()
        slot = self._slot  # read ONCE per tick: all queries see one version
        self._load(slot)
        done = 0
        for kind in QUERY_KINDS:
            q = self.queues[kind]
            if not q:
                continue
            reqs = [q.popleft() for _ in range(min(len(q), self.max_batch))]
            self._dispatch(slot, kind, reqs)
            done += len(reqs)
        self.ticks += 1
        self.tick_times.append(time.perf_counter() - t0)
        return done

    def run_until_drained(self, max_ticks: int = 1_000_000) -> int:
        """Tick until no work is pending; a staged-but-unswapped model counts
        as pending work (the swap happens only at a tick's start)."""
        done = 0
        while (any(self.queues.values()) or self._staged is not None) and max_ticks > 0:
            done += self.step()
            max_ticks -= 1
        return done

    def warmup(self, kinds=QUERY_KINDS, buckets=None) -> int:
        """Build the bucket ladder up front (dummy traffic through the real
        dispatch path) so steady-state serving never captures. Returns the
        number of executables built."""
        before = self.compile_count
        slot = self._slot
        self._load(slot)
        for kind in kinds:
            for b in buckets or self.buckets:
                reqs = [DensityRequest(0, kind, np.zeros(self.cfg.J, np.float32),
                                       n_obs=self.cfg.J) for _ in range(b)]
                self._dispatch(slot, kind, reqs)
        # warmup traffic is not served traffic
        for kind in kinds:
            self.served[kind] = 0
        self.bucket_counts.clear()
        self.replayed_launches.clear()
        return self.compile_count - before

    # -------------------------------------------------------------- hot swap

    def publish(self, params, scaler=None) -> int:
        """Stage a new model for the next tick (thread-safe, non-blocking).

        The staged slot becomes visible at the START of the next tick;
        queries of the in-flight tick finish on the old one. Re-publishing
        before the swap replaces the staged slot (last writer wins: both are
        complete models). Returns the new version. The slot's tensors are
        built before the lock is taken, so a tick never waits on them."""
        if scaler is None:
            cur = self._slot
            scaler = _ScalerView(cur.low.cpu().numpy(), cur.high.cpu().numpy())
        slot = _slot_from(0, params, scaler, self.device)
        with self._lock:
            self._version += 1
            self._staged = slot._replace(version=self._version)
            self.swap_events.append({"version": self._version,
                                     "published_s": time.perf_counter(), "visible_s": None})
            return self._version

    def stats(self) -> dict:
        ticks = np.asarray(self.tick_times, np.float64)
        return {
            "ticks": self.ticks,
            "served": dict(self.served),
            "compile_count": self.compile_count,
            "trace_counts": dict(self.trace_counts),
            "buckets": {f"{k}/{b}": c for (k, b), c in self.bucket_counts.items()},
            "version": self.version,
            "tick_p50_ms": float(np.percentile(ticks, 50) * 1e3) if ticks.size else 0.0,
            "tick_p99_ms": float(np.percentile(ticks, 99) * 1e3) if ticks.size else 0.0,
        }


@dataclasses.dataclass(frozen=True)
class _ScalerView:
    """DataScaler-shaped view over published bounds (``publish()`` without a
    new scaler keeps the current one)."""

    low: np.ndarray
    high: np.ndarray

    @property
    def inv_span(self) -> np.ndarray:
        return 1.0 / (self.high - self.low)


# ---------------------------------------------------------------------------
# background refit → publish (the coreset economics loop)
# ---------------------------------------------------------------------------


def refit_and_publish(
    engine: DensityServeEngine,
    scaler,
    Y=None,
    k: int | None = None,
    *,
    generator: torch.Generator | None = None,
    init=None,
    method: str = "lbfgs",
    steps: int = 60,
    lr: float = 5e-2,
    sketch_size: int = 0,
    chunk_size: int | None = None,
    coreset=None,
) -> int:
    """One refresh cycle: fresh coreset on ``Y`` → streamed fit → publish.
    Returns the published version. Synchronous: wrap with
    ``start_background_refit`` to overlap it with serving.

    ``coreset=(cs_Y, cs_weights)`` skips the build and fits an externally
    maintained coreset (the streaming maintainer's path); otherwise
    ``(Y, k)`` builds one (``build_coreset``, l2-hull). The build's draws
    and the fit's start come from ``generator``, unless ``init`` gives the
    start (the reference's, in parity tests).

    On the card the build and the fit run on a stream of their own, and the
    publish waits for an event recorded on it: a tick never copies
    parameters the refit has not finished writing. Every cycle appends
    ``{"version", "fit_nll_pp", "k", "build_s", "fit_s", "publish_s"}`` to
    ``engine.refit_log``: ``fit_nll_pp`` is the fitted model's NLL per
    weighted coreset point, the drift detector's anchor after the publish.
    """
    from repro_torch.core.mctm_fit import fit_mctm_streaming, streamed_nll
    from repro_torch.core.scoring import DEFAULT_CHUNK

    dev = engine.device
    chunk = DEFAULT_CHUNK if chunk_size is None else chunk_size
    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
    ctx = torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        if coreset is not None:
            cs_Y = np.asarray(coreset[0], np.float32)
            cs_w = np.asarray(coreset[1], np.float32)
        else:
            if Y is None or k is None:
                raise ValueError("refit_and_publish needs either coreset= or (Y, k)")
            from repro_torch.core.coreset import build_coreset

            cs = build_coreset(engine.cfg, scaler, Y, k, "l2-hull", generator=generator,
                               sketch_size=sketch_size, chunk_size=chunk, device=dev)
            cs_Y = np.asarray(Y)[cs.indices]
            cs_w = np.asarray(cs.weights, np.float32)
        t1 = time.perf_counter()
        fit = fit_mctm_streaming(engine.cfg, scaler, cs_Y, weights=cs_w, generator=generator,
                                 init=init, steps=steps, lr=lr, method=method, chunk_size=chunk,
                                 device=dev)
        fit_nll_pp = streamed_nll(engine.cfg, scaler, fit.params, cs_Y, weights=cs_w,
                                  chunk=chunk, device=dev) / max(float(cs_w.sum()), 1e-9)
        done = None
        if stream is not None:
            done = torch.cuda.Event()
            done.record(stream)
    if done is not None:
        done.synchronize()
    t2 = time.perf_counter()
    version = engine.publish(fit.params, scaler)
    t3 = time.perf_counter()
    engine.refit_log.append({"version": version, "fit_nll_pp": float(fit_nll_pp),
                             "k": int(cs_Y.shape[0]), "build_s": t1 - t0, "fit_s": t2 - t1,
                             "publish_s": t3 - t2})
    return version


def start_background_refit(engine: DensityServeEngine, *args, **kwargs):
    """``refit_and_publish`` on a daemon thread (serving continues on the
    caller's thread; the publish lands between ticks). Returns the started
    thread; ``join()`` it to wait for the publish."""
    th = threading.Thread(target=refit_and_publish, args=(engine, *args), kwargs=kwargs,
                          daemon=True)
    th.start()
    return th
