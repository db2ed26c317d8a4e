"""The port's hand-written collectives (``distributed/collectives.py``),
gradient compression with error feedback (``grad_compress.py``) and GPipe
forward (``pipeline_parallel.py``) against the JAX package's on the same
inputs: gloo worlds of 2 and 4 ranks against the reference's ``shard_map``
bodies on meshes of the first 2 and 4 of 8 fake CPU devices (one
subprocess, ``XLA_FLAGS=--xla_force_host_platform_device_count=8``).

Tolerances: the ring and reduce-scatter matmuls at the reference's own
(rtol 1e-4, atol 1e-3, ``tests/test_distributed.py``); the pipeline at atol
1e-5 (``tests/test_pipeline_parallel.py``). The int8 all-reduce and
``compress_and_average`` (two rounds, the second carrying the first's
residual) bit for bit: the scale is a max and the payload an int32 sum,
both exact, and each side rounds x / scale in f32 the same way;
``topk_sparsify`` bit for bit (a selection)."""
import os
import subprocess
import sys
import tempfile
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_shard_ranks import collectives  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

from repro_torch.distributed import run_world  # noqa: E402

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
WORLDS = (2, 4)


def _inputs(R: int) -> dict:
    rng = np.random.default_rng(3 + R)
    return {
        "X": rng.standard_normal((16, 64)).astype(np.float32),
        "W": rng.standard_normal((64, 32)).astype(np.float32),
        "Q": rng.standard_normal((R, 64)).astype(np.float32),
        "GA": rng.standard_normal((R, 5, 30)).astype(np.float32),
        "GB": (rng.standard_normal((R, 40)) * 1e-3).astype(np.float32),
        "LW": (rng.standard_normal((8, 16, 16)) * 0.1).astype(np.float32),
        "XM": rng.standard_normal((4, 2, 4, 16)).astype(np.float32),
    }


REFERENCE = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.utils.compat import shard_map
    from repro.distributed.collectives import (psum_quantized, reduce_scatter_matmul,
                                               ring_allgather_matmul)
    from repro.distributed.grad_compress import compress_and_average, init_error_state
    from repro.distributed.pipeline_parallel import pipeline_forward, split_stages

    out = {}
    for R in (2, 4):
        inp = dict(np.load(sys.argv[1] + f"_in{R}.npz"))
        devs = np.array(jax.devices()[:R])
        model = Mesh(devs, ("model",))
        data = Mesh(devs, ("data",))
        X, W = jnp.asarray(inp["X"]), jnp.asarray(inp["W"])
        out[f"ring{R}"] = np.asarray(ring_allgather_matmul(X, W, model, "model"))
        out[f"rs{R}"] = np.asarray(reduce_scatter_matmul(X, W, model, "model"))
        fn = shard_map(lambda xs: psum_quantized(xs[0], "data", bits=8)[None], mesh=data,
                       in_specs=(P("data", None),), out_specs=P("data", None))
        out[f"psum_q{R}"] = np.asarray(fn(jnp.asarray(inp["Q"])))

        def rounds(ga, gb):
            g = {"a": ga[0], "b": gb[0]}
            e = init_error_state(g)
            res = []
            for _ in range(2):
                avg, e = compress_and_average(g, e, data, "data")
                res += [avg["a"][None], avg["b"][None], e["a"][None], e["b"][None]]
            return tuple(res)

        spec = P("data")
        fn = shard_map(rounds, mesh=data, in_specs=(spec, spec), out_specs=(spec,) * 8)
        res = fn(jnp.asarray(inp["GA"]), jnp.asarray(inp["GB"]))
        for i, name in enumerate(("avg_a0", "avg_b0", "err_a0", "err_b0",
                                  "avg_a1", "avg_b1", "err_a1", "err_b1")):
            out[f"{name}_{R}"] = np.asarray(res[i])
        from repro.distributed.grad_compress import topk_sparsify
        out[f"topk{R}"] = np.stack([np.asarray(topk_sparsify(jnp.asarray(g), 0.1))
                                    for g in inp["GA"]])
        stage = Mesh(devs, ("stage",))
        lw = jnp.asarray(inp["LW"])
        out[f"pipe{R}"] = np.asarray(pipeline_forward(
            jnp.asarray(inp["XM"]), split_stages(lw, R), lambda w, h: jnp.tanh(h @ w), stage))
    np.savez(sys.argv[1] + "_out.npz", **out)
""")


@pytest.fixture(scope="module")
def results():
    with tempfile.TemporaryDirectory() as tmp:
        base = os.path.join(tmp, "coll")
        inputs = {R: _inputs(R) for R in WORLDS}
        for R, inp in inputs.items():
            np.savez(base + f"_in{R}.npz", **inp)
        env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
        proc = subprocess.Popen([sys.executable, "-c", REFERENCE, base], env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            with ThreadPoolExecutor(len(WORLDS)) as pool:
                futs = {R: pool.submit(run_world, collectives, R, backend="gloo",
                                       devices=["cpu"] * R, args=(inputs[R],), timeout_s=300)
                        for R in WORLDS}
                port = {R: f.result() for R, f in futs.items()}
            _, err = proc.communicate(timeout=600)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        assert proc.returncode == 0, err[-3000:]
        ref = dict(np.load(base + "_out.npz"))
    return inputs, port, ref


@pytest.mark.parametrize("R", WORLDS)
def test_ring_and_reduce_scatter_matmuls(results, R):
    inputs, port, ref = results
    want = inputs[R]["X"] @ inputs[R]["W"]
    rows = want.shape[0] // R
    for r, got in enumerate(port[R]):
        np.testing.assert_allclose(got["ring"], ref[f"ring{R}"], rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got["ring"], want, rtol=1e-4, atol=1e-3)
        np.testing.assert_allclose(got["rs"], ref[f"rs{R}"][r * rows:(r + 1) * rows],
                                   rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("R", WORLDS)
def test_quantized_all_reduce_is_the_references(results, R):
    _, port, ref = results
    for r, got in enumerate(port[R]):
        np.testing.assert_array_equal(got["psum_q"], ref[f"psum_q{R}"][r])


@pytest.mark.parametrize("R", WORLDS)
def test_compress_and_average_is_the_references(results, R):
    _, port, ref = results
    for r, got in enumerate(port[R]):
        for t in range(2):
            for leaf in ("a", "b"):
                np.testing.assert_array_equal(got["compress_avg"][t][leaf],
                                              ref[f"avg_{leaf}{t}_{R}"][r])
                np.testing.assert_array_equal(got["compress_err"][t][leaf],
                                              ref[f"err_{leaf}{t}_{R}"][r])
        np.testing.assert_array_equal(got["topk"], ref[f"topk{R}"][r])


@pytest.mark.parametrize("R", WORLDS)
def test_pipeline_forward_matches_the_reference_and_sequential(results, R):
    inputs, port, ref = results
    seq = torch.tensor(inputs[R]["XM"])
    for w in torch.tensor(inputs[R]["LW"]):
        seq = torch.tanh(seq @ w)
    for got in port[R]:
        np.testing.assert_allclose(got["pipeline"], ref[f"pipe{R}"], atol=1e-5)
        np.testing.assert_array_equal(got["pipeline"], seq.numpy())
