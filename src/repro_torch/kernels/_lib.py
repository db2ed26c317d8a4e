"""Build and load the port's CUDA kernels (``repro_torch/csrc/*.cu``).

The sources are compiled with ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The build runs at first use
— never at import — into ``build/repro_torch/<hash>/`` at the repository
root, keyed by a hash of the sources and flags, so an edited source builds
anew. Each ``.cu`` file compiles to an object in its own ``nvcc`` process,
all started together, and one more ``nvcc`` links them. Each compile runs
with ``-Xptxas -v``; its report (registers, shared memory and spills of
every kernel) is kept in ``BUILD_LOG`` by source name.

Every exported function launches on the stream it is given, allocates
nothing and returns the ``cudaError_t`` of its launches; ``check`` raises on
a nonzero code. A failed build or launch raises ``KernelError``, which the
fault-tolerance supervisor never retries (``ft/supervisor.py``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import functools
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# argtypes of every exported function: pointers and the stream as c_void_p
_SIGNATURES = {
    "repro_bernstein_featurize": (_P, _L, _I, _I, _P, _P, _P, _P),
    "repro_gram": (_P, _P, _I, _I, _P, _P, _P, _P, _I, _P),
    "repro_gram_tiled_plan": (_I, _P),
    "repro_extremes": (_P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "repro_sweep": (
        _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P, _I, _P, _I, _P, _I, _P, _P, _I, _I, _I,
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
    ),
    "repro_flash_attention": (
        _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L, _L, _L, _L, _L, _I, _F,
        _P,
    ),
    "repro_ssd": (
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _L, _L, _L, _L, _L,
        _L, _L, _L, _P,
    ),
}
# the limits and launch units of csrc/ that the wrappers check and plan with,
# by source and name; tests/test_torch_structure.py holds each to its
# constexpr (or #define) there
CUDA_CONSTANTS = {
    "common.cuh": {"REPRO_MAX_DP": 16, "kExtWarpDirs": 128, "kExtMaxWarps": 13, "kExtTile": 16,
                   "kExtCtasPerSm": 2, "kExtMaxBlockRows": 512},
    "extremes.cu": {"kExtWideRd": 8, "kExtWideRr": 8, "kExtWideTileDirs": 128,
                    "kExtWideTileRows": 128, "kExtWideCtasPerSm": 2, "kExtWideOneWarps": 4,
                    "kExtWideOneCtasPerSm": 4},
    "gram.cu": {"kMaxD": 64, "kWideMaxD": 160, "kWideCluster": 8, "kWideMaxGroups": 16,
                "kWideScratchFloats": 458_752, "kLargeTile": 128, "kLargeStageRows": 32,
                "kLargeCtasPerSm": 1, "kLargeMaxSplits": 64},
    "sweep.cu": {"kSlabCols": 160, "kXwStageFloats": 12_288, "kTileMaxThreads": 256,
                 "kTileEntries": 256, "kMaxParts": 64, "kPartPoints": 128},
}



class KernelError(RuntimeError):
    """A kernel that does not build or does not launch: a fault of the
    program, not a transient one, so no supervisor retries it."""


_LIB: ctypes.CDLL | None = None
BUILD_SECONDS: float | None = None  # wall time of this process's build, if it built
BUILD_LOG: dict[str, str] = {}  # nvcc/ptxas output of each source, if this process built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelError(
        "nvcc not found: the port's CUDA kernels build from source at first "
        "use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build(out_dir: Path) -> Path:
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "librepro_torch.so"
    objs = []
    procs = []
    for src in _sources():
        obj = out_dir / f"{src.stem}.{os.getpid()}.o"
        objs.append(obj)
        procs.append((src, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )))
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        BUILD_LOG[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise KernelError("nvcc failed:\n" + "\n".join(failed))
    tmp = out_dir / f"librepro_torch.{os.getpid()}.so"
    link = subprocess.run(
        [nvcc, "-shared", *(str(o) for o in objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode != 0:
        raise KernelError(f"nvcc link failed:\n{link.stdout}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    for o in objs:
        o.unlink(missing_ok=True)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on the first call."""
    global _LIB, BUILD_SECONDS
    if _LIB is not None:
        return _LIB
    so = BUILD_ROOT / _digest() / "librepro_torch.so"
    if not so.exists():
        t0 = time.perf_counter()
        so = _build(so.parent)
        BUILD_SECONDS = time.perf_counter() - t0
    handle = ctypes.CDLL(str(so))
    for name, args in _SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = list(args)
        fn.restype = ctypes.c_int
    _LIB = handle
    return handle


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def ptr(t: torch.Tensor | None) -> int | None:
    """Device pointer of a tensor (None → NULL)."""
    return None if t is None else t.data_ptr()


def check(code: int, name: str) -> None:
    if code != 0:
        raise KernelError(f"{name}: CUDA launch failed with cudaError_t {code}")


def require_cuda(*tensors: torch.Tensor | None) -> None:
    """Kernel inputs: CUDA, float32/int32 as given, contiguous, one device."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs must all lie on one CUDA device, got {devs}")
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")


# calls each wrapper sent to its plain version (a CPU tensor), by kernel: the
# CPU's count of what the wrappers' LAUNCHES count on the card (the invariant
# auditor's kernel census, ``repro_torch.analysis``)
PLAIN_CALLS: dict[str, int] = {}


def resolve_backend(backend: str | None, x: torch.Tensor, name: str) -> str:
    """The dispatch contract of every wrapper: a CUDA tensor runs the
    kernel, a CPU tensor the plain version (``ref.py``). ``backend`` may
    only name the path the tensor's device selects; anything else raises."""
    path = "cuda" if x.device.type == "cuda" else "torch"
    if backend is not None:
        if backend not in ("cuda", "torch"):
            raise ValueError(f"unknown {name} backend: {backend!r} (expected 'cuda' or 'torch')")
        if backend != path:
            raise ValueError(
                f"{name} backend {backend!r} does not run on a {x.device.type} tensor: "
                "CUDA tensors go to the kernel, CPU tensors to the plain version"
            )
    if path == "torch":
        PLAIN_CALLS[name] = PLAIN_CALLS.get(name, 0) + 1
    return path
