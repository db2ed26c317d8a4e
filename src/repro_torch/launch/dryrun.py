"""Multi-pod dry run of the LM zoo: trace every (arch × shape × mesh) cell —
the port of ``repro.launch.dryrun``.

For each cell rank 0's program (the train step, the prefill or the decode
step) is traced on the reference's production mesh, 16×16 (256 ranks) or
2×16×16 (512), never executed: the mesh is a ``DeviceMesh`` of an
in-process fake world (``launch.mesh.make_production_device_mesh``), the
parameters, optimizer state, batch and cache are DTensors of
fake tensors distributed by the resolved logical specs
(``distributed/sharding.py``: FSDP "embed → data" for training; serving
replicates over the batch axes and keeps bf16 weights), and DTensor's
sharding propagation places every op. Nothing is allocated and nothing runs
on a device: the dry run is CPU-only by nature, as the reference's is on
placeholder devices, and the kernel wrappers take their plain versions on
the fake CPU tensors (the prefill's peak then holds the plain attention's
(S, S) weights, which the card's flash kernel never does).

Each record holds, for one rank:
  * ``hlo_flops``: the FLOPs of the rank's local ops (``RankTrace``: a
    dispatch mode that lets each DTensor op desugar into its local ops and
    counts only those, with ``FlopCounterMode``'s registry — matmul-family
    ops; counting the global DTensor op too would count the work twice);
  * ``hlo_bytes``: bytes read and written by the local non-view ops (the
    auditor's convention, ``analysis.checks.OpTrace``);
  * collectives by kind and their result bytes (DTensor's functional
    collectives, the reference's convention of result bytes per device);
  * ``memory_analysis``: the argument bytes (the rank's shards of params,
    optimizer state, batch and cache), the peak of live intermediate bytes
    (each local op's output from its creation until its tensor is freed;
    autograd's saved tensors keep theirs alive), and their sum; ``fits``
    says whether the sum fits the card's 80 GB;
  * ``redistributions``: the named points where the model redistributes an
    operand for an op DTensor has no rule for (``sharding.REDISTRIBUTIONS``);
  * the roofline terms of ``launch/roofline.py`` (H100 constants) with the
    reference's ``analytic_flops``.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape decode_32k
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k --multi-pod
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--skip-existing]

Writes ``results/dryrun/torch_<arch>__<shape>__<mesh>.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch.roofline import analytic_flops, count_params, roofline_terms
from repro_torch.launch.shapes import (
    SHAPES,
    cell_supported,
    decode_token_specs,
    prefill_batch_specs,
    train_batch_specs,
)

RESULTS_DIR = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                            "..", "..", "..", "results", "dryrun"))
CARD_BYTES = 80e9  # the H100's 80 GB of device memory

# per-arch training knobs (memory-driven): microbatch count + optimizer
TRAIN_MICROBATCHES = {"arctic-480b": 16, "minicpm3-4b": 8}
DEFAULT_MICROBATCHES = 8
ADAFACTOR_ARCHS = {"arctic-480b"}  # 0.5T params: factored moments required

# DTensor's functional collectives (the ops of torch.ops._c10d_functional
# that move data between ranks)
COLLECTIVES = frozenset({
    "all_gather_into_tensor", "all_gather_into_tensor_coalesced", "reduce_scatter_tensor",
    "reduce_scatter_tensor_coalesced", "all_reduce", "all_reduce_coalesced",
    "all_to_all_single", "broadcast"})

__all__ = ["lower_cell", "run_cell_to_file", "main", "RankTrace", "TRAIN_MICROBATCHES",
           "ADAFACTOR_ARCHS"]


class RankTrace(TorchDispatchMode):
    """Counts one rank's local work under DTensor: an op on DTensors is
    handed back (``NotImplemented``) so that DTensor runs it and its local
    ops and collectives reach this mode, which counts their FLOPs, bytes,
    collectives and live output bytes. Under fake tensors it answers a host
    read (``aten._local_scalar_dense``) with zeros and counts it."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import FlopCounterMode

        self.registry = FlopCounterMode(display=False).flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: dict = {}
        self.host_reads = 0
        self.live = 0
        self.peak = 0
        self.largest: list = []  # the five largest local outputs: (bytes, op, shape)

    def _freed(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        from repro_torch.analysis.checks import _placeholder, _tensors

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        if func is torch.ops.aten._local_scalar_dense.default:
            self.host_reads += 1
            return _placeholder(args[0].dtype)
        out = func(*args, **kwargs)
        if func.is_view or _in_propagation():
            return out
        outs = list(_tensors(out))
        if not outs:
            return out
        ins = list(_tensors((args, kwargs)))
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += int(self.registry[packet](*args, **kwargs, out_val=out))
        nbytes = sum(t.numel() * t.element_size() for t in outs)
        self.bytes += sum(t.numel() * t.element_size() for t in ins) + nbytes
        if packet.__name__ in COLLECTIVES and func.namespace in ("_c10d_functional",
                                                                  "c10d_functional"):
            rec = self.collectives.setdefault(packet.__name__, {"count": 0, "bytes": 0})
            rec["count"] += 1
            rec["bytes"] += nbytes
        for t in outs:
            if any(t is a for a in ins):  # in place: no new memory
                continue
            n = t.numel() * t.element_size()
            self.live += n
            weakref.finalize(t, self._freed, n)
            if len(self.largest) < 5 or n > self.largest[-1][0]:
                self.largest = sorted(self.largest + [(n, str(func), list(t.shape))],
                                      reverse=True)[:5]
        self.peak = max(self.peak, self.live)
        return out

    def add_collective(self, kind: str, nbytes: int) -> None:
        """A collective the program makes outside the trace."""
        rec = self.collectives.setdefault(kind, {"count": 0, "bytes": 0})
        rec["count"] += 1
        rec["bytes"] += int(nbytes)

    def collective_bytes(self) -> int:
        return sum(v["bytes"] for v in self.collectives.values())


_PROPAGATION = os.sep + os.path.join("distributed", "tensor", "_sharding_prop.py")


def _in_propagation() -> bool:
    """True while DTensor's sharding propagation runs an op on global-shape
    meta tensors to infer its output (no rank computes it)."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_filename.endswith(_PROPAGATION):
            return True
        f = f.f_back
    return False


def _optimizer(arch: str):
    from repro_torch.optim import adafactor, adamw

    if arch in ADAFACTOR_ARCHS:
        return adafactor(1e-4)
    return adamw(3e-4)


def shard_bytes(specs, shapes, mesh, rules) -> int:
    """Bytes of one rank's shards of the tree ``shapes`` under its logical
    ``specs`` resolved on ``mesh`` (the reference's ``shard_shape`` sizes)."""
    from repro_torch.distributed.sharding import resolve_tree, shard_shape
    from repro_torch.utils.tree import tree_leaves

    sh = tree_leaves(resolve_tree(specs, shapes, mesh, rules),
                     is_leaf=lambda n: hasattr(n, "spec"))
    total = 0
    for s, x in zip(sh, tree_leaves(shapes), strict=True):
        n = 1
        for d in shard_shape(s.spec, tuple(x.shape), mesh):
            n *= d
        total += n * x.dtype.itemsize
    return total


def _batch_bytes(batch: dict, mesh, rules) -> int:
    from repro_torch.distributed.sharding import batch_specs

    from repro_torch.distributed.sharding import shard_shape

    total = 0
    for k, sh in batch_specs(batch, mesh, rules).items():
        n = 1
        for d in shard_shape(sh.spec, tuple(batch[k].shape), mesh):
            n *= d
        total += n * batch[k].dtype.itemsize
    return total


def _zeros(specs: dict) -> dict:
    return {k: torch.zeros(v.shape, dtype=v.dtype, device="meta") for k, v in specs.items()}


def _to_meta(model) -> None:
    """The model's parameters (drawn as fake tensors) replaced by meta
    tensors: DTensor's own bookkeeping then runs on real host tensors,
    which it cannot under ``FakeTensorMode``."""
    from torch import nn

    for mod in model.modules():
        if isinstance(mod, nn.ParameterDict):
            for k, p in list(mod.items()):
                mod[k] = nn.Parameter(torch.empty(p.shape, dtype=p.dtype, device="meta"),
                                      requires_grad=p.requires_grad)


def serving_tree(model) -> dict:
    """A serving model's parameters as a tree in its per-layer layout (the
    layout ``models.specs.param_specs`` names without "layer")."""
    def parts(block):
        return {part: dict(pd.items()) for part, pd in block.named_children()}

    if model.cfg.family == "encdec":
        return {"emb": dict(model.emb.items()), "enc": [parts(b) for b in model.enc],
                "dec": [parts(b) for b in model.dec], "ln_enc": dict(model.ln_enc.items()),
                "ln_dec": dict(model.ln_dec.items())}
    return {"emb": dict(model.emb.items()), "layers": [parts(b) for b in model.layers],
            "ln_f": dict(model.ln_f.items())}


def _distribute_cache(cache, cfg, mesh, rules):
    """The cache's leaves as DTensors of their resolved specs ("pos", a
    scalar, stays a plain tensor, the same on every rank)."""
    from repro_torch.distributed.sharding import resolve_tree
    from repro_torch.models.specs import cache_specs
    from repro_torch.train.trainer import _distribute
    from repro_torch.utils.tree import tree_map

    sh = resolve_tree(cache_specs(cfg), cache, mesh, rules)
    return tree_map(lambda s, x: x if x.ndim == 0 else _distribute(x, s), sh, cache,
                    is_leaf=lambda n: hasattr(n, "placements"))


def lower_cell(
    arch: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    remat: str = "full",
    xent_chunk: int = 512,
    fsdp: bool = True,
    microbatches: int | None = None,
    rules_override=None,
    overrides: dict | None = None,
    act_constraints: bool = False,
    prefill_chunk: int = 0,
    cfg=None,
    mesh_shape: tuple | None = None,
    shape=None,
) -> dict:
    """Trace one cell; return its roofline record (raises on failure).
    ``cfg``, ``mesh_shape`` (a (pod, data, model) or (data, model) fake
    world) and ``shape`` (a ``ShapeConfig``) replace the named config, the
    production mesh and the named shape (tests trace a reduced cell)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import close_fake_world, make_production_device_mesh
    from repro_torch.models import build_model
    from repro_torch.models.specs import param_specs
    from repro_torch.train.state import init_train_state
    from repro_torch.models.transformer import cache_shapes_and_specs
    from repro_torch.train.trainer import (_distribute, _distribute_masters, make_train_step,
                                           shard_train_step)
    from repro_torch.utils.tree import tree_leaves

    t0 = time.time()
    cfg = cfg or get_config(arch)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": True, "reason": reason}

    mesh = (_fake_mesh(mesh_shape) if mesh_shape is not None
            else make_production_device_mesh(multi_pod=multi_pod))
    act = dict(SH._ACT)
    try:
        chips = mesh.size()
        mesh_name = "x".join(str(mesh.size(i)) for i in range(mesh.ndim))
        # serving: no FSDP (params replicated over the batch axes, TP over
        # model) and bf16 weights; training: FSDP f32 masters
        serve = shape.kind != "train"
        rules = rules_override or SH.default_rules(mesh, fsdp=fsdp and not serve)
        # a multi-pod mesh is traced as rank 0's pod (module doc): its
        # (data, model) submesh and the pod's share of the batch
        pods = mesh.size(0) if "pod" in mesh.mesh_dim_names else 1
        local = mesh["data", "model"] if pods > 1 else mesh
        local_rules = (rules if pods == 1 else
                       SH.default_rules(local, fsdp=fsdp and not serve))
        batch_ways = SH._axis_size(SH.mesh_axes(mesh), rules.get("batch"))
        share = pods if shape.global_batch % batch_ways == 0 else 1
        pod_shape = dataclasses.replace(shape, global_batch=shape.global_batch // share)
        SH.set_activation_axes(batch=local_rules.get("batch"), model=("model",),
                               enabled=act_constraints or cfg.decode_seq_shard)
        SH.reset_redistributions()
        trace = RankTrace()
        scale = 1.0
        mb = mb_asked = None  # training only
        with FakeTensorMode():
            model = build_model(cfg, device="cpu", train=not serve, remat=remat,
                                xent_chunk=xent_chunk)
        _to_meta(model)
        if not serve:
            mb = mb_asked = microbatches or TRAIN_MICROBATCHES.get(arch, DEFAULT_MICROBATCHES)
            # a microbatch of fewer rows than the rank's batch axes would
            # leave its token dim to DTensor's choice, which splits it and
            # cannot unflatten it: fewer, larger microbatches (recorded)
            ways = SH._axis_size(SH.mesh_axes(local), local_rules.get("batch"))
            while mb > 1 and (pod_shape.global_batch // mb) % ways:
                mb //= 2
            opt = _optimizer(arch)
            params = model.param_tree()
            specs = param_specs(params)
            n_params = count_params(params)
            opt_shapes = opt.init(tree_leaves(params))
            full_batch = train_batch_specs(cfg, shape)
            args_bytes = {
                "params": shard_bytes(specs, params, mesh, rules),
                "opt_state": shard_bytes(opt.state_specs(specs, params), opt_shapes, mesh,
                                         rules),
                "batch": _batch_bytes(full_batch, mesh, rules)}
            step, _, _ = shard_train_step(make_train_step(model, opt, microbatches=mb),
                                          model, opt, local, local_rules,
                                          params_shapes=params, specs=specs)
            state = step.shard_state(init_train_state(params, opt))
            batch = _zeros(train_batch_specs(cfg, pod_shape))
            b_sh = SH.batch_specs(batch, local, local_rules)
            batch = {k: _distribute(v, b_sh[k]) for k, v in batch.items()}
            with trace:
                step(state, batch)
            if pods > 1:
                # the pure data parallelism over "pod": the gradient
                # shards (f32, as the masters) all-reduced across pods
                trace.add_collective("all_reduce_pod", args_bytes["params"])
            kind = "train"
        else:
            tree = serving_tree(model)
            specs = param_specs(tree)
            n_params = count_params(tree)
            _distribute_masters(model, tree, SH.resolve_tree(specs, tree, local, local_rules))
            cache_shapes, cspecs = cache_shapes_and_specs(cfg, shape.global_batch,
                                                          shape.seq_len)
            B = pod_shape.global_batch
            cache = _distribute_cache(model.init_cache(B, shape.seq_len), cfg, local,
                                      local_rules)
            if shape.kind == "prefill":
                b = prefill_batch_specs(cfg, pod_shape)
                if prefill_chunk and cfg.family != "encdec":
                    # chunked prefill: the per-chunk incremental step (writes
                    # into the full-length cache at pos); the whole prefill
                    # is S/chunk such steps, so FLOPs, bytes and collectives
                    # scale back up by that factor while the peak is a chunk's
                    b = dict(b, tokens=torch.empty((B, prefill_chunk), dtype=torch.int32,
                                                  device="meta"))
                    b.pop("patch_embeds", None)  # patch prefix: chunk 0 only
                    scale = shape.seq_len / prefill_chunk
                full_batch = {k: torch.empty((v.shape[0] * share,) + tuple(v.shape[1:]),
                                             dtype=v.dtype) for k, v in b.items()}
                b = _zeros(b)
                b_sh = SH.batch_specs(b, local, local_rules)
                inputs = {k: _distribute(v, b_sh[k]) for k, v in b.items()}
                kind = "prefill"
            else:
                full_batch = {"tokens": decode_token_specs(shape)}
                tok = torch.zeros(decode_token_specs(pod_shape).shape, dtype=torch.int32,
                              device="meta")
                inputs = _distribute(tok, SH.batch_specs({"tokens": tok}, local,
                                                         local_rules)["tokens"])
                kind = "decode"
            args_bytes = {"params": shard_bytes(specs, tree, mesh, rules),
                          "cache": shard_bytes(cspecs, cache_shapes, mesh, rules),
                          "batch": _batch_bytes(full_batch, mesh, rules)}
            fn = model.prefill if kind == "prefill" else model.decode_step
            with trace, implicit_replication(), SH.dtensor_run():
                fn(inputs, cache)
        redistributions = {k: dict(v) for k, v in SH.REDISTRIBUTIONS.items()}
    finally:
        SH._ACT.update(act)
        close_fake_world()

    arg_total = sum(args_bytes.values())
    peak = arg_total + trace.peak
    ana, model_flops = analytic_flops(cfg, n_params, shape, kind)
    report = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        hlo_flops=float(trace.flops) * scale, hlo_bytes=float(trace.bytes) * scale,
        collective_bytes=float(trace.collective_bytes()) * scale,
        collective_by_op={k: dict(v) for k, v in trace.collectives.items()},
        model_flops=model_flops, analytic=ana, peak_memory_bytes=float(peak),
        note="rank 0 traced on DTensors of fake tensors; FLOPs count the local "
             "matmul-family ops only")
    rec = report.to_json()
    rec.update({
        "kind": kind,
        "n_params": n_params,
        "microbatches": mb,
        "microbatches_asked": mb_asked,
        "memory_analysis": {"argument_size_in_bytes": arg_total,
                            "argument_bytes": args_bytes,
                            "temp_size_in_bytes": trace.peak,
                            "peak_memory_in_bytes": peak},
        "fits": peak <= CARD_BYTES,
        "card_bytes": CARD_BYTES,
        "redistributions": redistributions,
        "host_reads": trace.host_reads,
        "largest_buffers": trace.largest,
        "compile_seconds": time.time() - t0,
        "multi_pod": multi_pod,
        "skipped": False,
        "remat": remat,
        "fsdp": fsdp,
    })
    return rec


def _fake_mesh(shape: tuple):
    """A ``DeviceMesh`` of ``shape`` over a fresh fake world (tests)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    names = ("pod", "data", "model")[-len(shape):]
    world = 1
    for s in shape:
        world *= s
    if dist.is_initialized():
        raise RuntimeError("a process group is already the default group")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    return init_device_mesh("cpu", tuple(shape), mesh_dim_names=names)


def run_cell_to_file(arch, shape_name, multi_pod, out_dir, skip_existing=True, variant="",
                     **kw):
    os.makedirs(out_dir, exist_ok=True)
    tag = f"torch_{arch}__{shape_name}__{'2x16x16' if multi_pod else '16x16'}"
    if variant:
        tag += f"__opt-{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if skip_existing and os.path.exists(path):
        print(f"[skip existing] {tag}")
        return path
    print(f"[trace] {tag} ...", flush=True)
    try:
        rec = lower_cell(arch, shape_name, multi_pod=multi_pod, **kw)
        rec["variant"] = variant or "baseline"
    except Exception as e:  # record failures — they are bugs to fix
        rec = {
            "arch": arch,
            "shape": shape_name,
            "multi_pod": multi_pod,
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
            "skipped": False,
        }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = "ERROR " + rec["error"][:120] if "error" in rec else (
        "SKIP " + rec.get("reason", "") if rec.get("skipped") else
        f"ok compute={rec['compute_s']:.4f}s mem={rec['memory_s']:.4f}s "
        f"coll={rec['collective_s']:.4f}s dom={rec['dominant']} "
        f"peak={rec['peak_memory_bytes'] / 1e9:.2f}GB fits={rec['fits']}"
    )
    print(f"[done] {tag}: {status}", flush=True)
    return path


def _parse_overrides(pairs: list[str]) -> dict:
    out = {}
    for p in pairs or []:
        k, _, v = p.partition("=")
        if v.lower() in ("true", "false"):
            out[k] = v.lower() == "true"
        else:
            try:
                out[k] = int(v)
            except ValueError:
                try:
                    out[k] = float(v)
                except ValueError:
                    out[k] = v
    return out


def main(argv=None) -> list[str]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=RESULTS_DIR)
    ap.add_argument("--skip-existing", action="store_true", default=True)
    ap.add_argument("--no-skip-existing", dest="skip_existing", action="store_false")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--xent-chunk", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument(
        "--override", action="append", default=[],
        help="ModelConfig field=value (e.g. decode_seq_shard=true)",
    )
    ap.add_argument("--variant", default="", help="tag for variant records")
    ap.add_argument("--act-constraints", action="store_true",
                    help="enable logical activation sharding constraints")
    ap.add_argument("--no-fsdp", dest="fsdp", action="store_false", default=True,
                    help="replicate params over the data axis (small models)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="trace the per-chunk incremental prefill step")
    args = ap.parse_args(argv)

    arch_list = list(ARCH_IDS) if (args.all or args.arch is None) else [args.arch]
    shape_list = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ([False, True] if (args.both_meshes or (args.all and not args.multi_pod))
              else [args.multi_pod])
    overrides = _parse_overrides(args.override)

    paths = []
    for mp in meshes:
        for arch in arch_list:
            for shape_name in shape_list:
                paths.append(run_cell_to_file(
                    arch, shape_name, mp, args.out,
                    skip_existing=args.skip_existing, remat=args.remat,
                    xent_chunk=args.xent_chunk, microbatches=args.microbatches,
                    overrides=overrides, variant=args.variant,
                    act_constraints=args.act_constraints, fsdp=args.fsdp,
                    prefill_chunk=args.prefill_chunk,
                ))
    return paths


if __name__ == "__main__":
    main()
