"""Hull primitives of the port against the JAX package's on the same seeded
inputs: greedy_hull_projection's support ids exactly, with t and dists to
1e-6 (the same float32 steps; norms and dots may round in another order);
epsilon_kernel_indices' ids exactly with the reference's own normal draws,
for n ≤ k, and with a float64 net, which the port scores in float32."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import hull as RH  # noqa: E402
from repro_torch.core import hull as TH  # noqa: E402


@pytest.mark.parametrize("case", ["interior", "exterior", "far", "no_steps"])
def test_greedy_projection_matches_reference(case):
    rng = np.random.default_rng({"interior": 0, "exterior": 1, "far": 2, "no_steps": 3}[case])
    P = rng.standard_normal((300, 3)).astype(np.float32)
    q, eps, max_iter = {
        "interior": (np.zeros(3), 1e-3, 96),
        "exterior": (np.array([4.0, -1.0, 0.5]), 1e-2, 64),
        "far": (np.array([40.0, 30.0, -20.0]), 1e-2, 16),
        "no_steps": (np.array([3.0, 0.0, 0.0]), 1e-2, 0),
    }[case]
    t_ref, s_ref, d_ref = RH.greedy_hull_projection(jnp.asarray(P), jnp.asarray(q), eps, max_iter)
    t, s, d = TH.greedy_hull_projection(P, q, eps, max_iter, device="cpu")
    assert s.shape == (max_iter + 1,) and d.shape == (max_iter,) and s.dtype == torch.int64
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_ref))
    np.testing.assert_allclose(t.numpy(), np.asarray(t_ref), rtol=0, atol=1e-6)
    np.testing.assert_allclose(d.numpy(), np.asarray(d_ref), rtol=0, atol=1e-6)
    if case == "interior":
        assert (s.numpy() == -1).any()  # converged: the frozen steps record −1


def test_hull_distance_matches_reference():
    rng = np.random.default_rng(0)
    P = rng.random((200, 2)).astype(np.float32)
    for q in (np.array([0.5, 0.5]), np.array([3.0, 3.0])):
        ref = RH.hull_distance(jnp.asarray(P), jnp.asarray(q), eps=1e-3, max_iter=128)
        got = TH.hull_distance(P, q, eps=1e-3, max_iter=128, device="cpu")
        assert got == pytest.approx(ref, abs=1e-6)


@pytest.mark.parametrize("n,d,k", [(800, 7, 40), (2000, 2, 16), (500, 5, 120)])
def test_epsilon_kernel_matches_reference(n, d, k):
    rng = np.random.default_rng(n + d)
    P = (rng.standard_normal((n, d)) * rng.uniform(0.5, 2.0, d)).astype(np.float32)
    key = jax.random.PRNGKey(k)
    ref = RH.epsilon_kernel_indices(P, k, key)
    normals = np.asarray(jax.random.normal(key, (max(4 * k, 8), d), dtype=jnp.float32))
    got = TH.epsilon_kernel_indices(P, k, normals=normals, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, ref)


def test_epsilon_kernel_small_n_and_float64_net():
    P = np.eye(3, dtype=np.float32)
    np.testing.assert_array_equal(TH.epsilon_kernel_indices(P, 10, device="cpu"),
                                  RH.epsilon_kernel_indices(P, 10, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(9)
    P = rng.standard_normal((600, 4)).astype(np.float32)
    dirs64 = rng.standard_normal((50, 4))
    dirs64 /= np.linalg.norm(dirs64, axis=1, keepdims=True)
    got = TH.epsilon_kernel_indices(P, 30, dirs=dirs64, device="cpu")
    # the port scores the net rounded to float32 ...
    np.testing.assert_array_equal(
        got, TH.epsilon_kernel_indices(P, 30, dirs=dirs64.astype(np.float32), device="cpu"))
    # ... where the reference scores it in float64: the same ids on these points
    np.testing.assert_array_equal(got, RH.epsilon_kernel_indices(P, 30, None, dirs=dirs64))
    with pytest.raises(ValueError):
        TH.epsilon_kernel_indices(P, 30, device="cpu")  # no net, no normals, no generator
    a = TH.epsilon_kernel_indices(P, 30, generator=torch.Generator().manual_seed(1), device="cpu")
    b = TH.epsilon_kernel_indices(P, 30, generator=torch.Generator().manual_seed(1), device="cpu")
    np.testing.assert_array_equal(a, b)
