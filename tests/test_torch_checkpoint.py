"""The port's checkpoint manager (``repro_torch.checkpoint``) against the
reference's: the reference's seven ``test_checkpoint.py`` cases on torch
states, and checkpoints that cross the packages — written by one, restored
by the other, for a dict and a NamedTuple state — with the same leaf names
and arrays."""
import json
import os
from typing import NamedTuple

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import CheckpointManager as RefManager  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import flatten_with_names  # noqa: E402


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 8, generator=g), "b": torch.zeros(8)},
        "opt": {"m": torch.ones(8, 8), "step": torch.tensor(5, dtype=torch.int32)},
    }


def _zeros_like(state):
    return {k: {kk: torch.zeros_like(v) for kk, v in d.items()} for k, d in state.items()}


def _leaves(state):
    return [x for _, x in flatten_with_names(state)]


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    state = _state()
    mgr.save(10, state)
    restored = mgr.restore(_zeros_like(state))
    for a, b in zip(_leaves(state), _leaves(restored)):
        assert isinstance(b, torch.Tensor) and b.dtype == a.dtype and torch.equal(a, b)


def test_latest_and_keep_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, _state(s))
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_restore_specific_step(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5)
    for s in (1, 2):
        mgr.save(s, {"x": torch.full((3,), float(s))})
    out = mgr.restore({"x": np.zeros(3)}, step=1)
    np.testing.assert_array_equal(out["x"], np.ones(3))


def test_crash_mid_save_leaves_previous_intact(tmp_path):
    """A stray .tmp dir (simulated crash) must not corrupt restore."""
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    os.makedirs(os.path.join(str(tmp_path), "step_00000002.tmp"))
    assert mgr.latest_step() == 1
    assert mgr.restore(_zeros_like(_state(1))) is not None


def test_torn_write_fully_populated_tmp_ignored_and_reclaimed(tmp_path):
    """The crash lands after every leaf and the manifest are fsynced but
    before the rename (the injection point): the torn tmp stays invisible,
    the retried save commits, GC reclaims the debris."""
    from repro_torch.ft.config import get_ft_config
    from repro_torch.ft.failure import FailureSimulator, InjectedFailure

    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, _state(1))
    ft = get_ft_config()
    ft.simulator = FailureSimulator().inject("checkpoint", 2)
    try:
        with pytest.raises(InjectedFailure):
            mgr.save(2, _state(2))
    finally:
        ft.simulator = None
    torn = os.path.join(str(tmp_path), "step_00000002.tmp")
    assert os.path.exists(os.path.join(torn, "manifest.json"))
    assert mgr.latest_step() == 1
    restored = mgr.restore(_zeros_like(_state(1)))
    for a, b in zip(_leaves(_state(1)), _leaves(restored)):
        assert torch.equal(a, b)
    mgr.save(2, _state(2))
    assert mgr.latest_step() == 2
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))


def test_shape_mismatch_rejected(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"x": torch.zeros(4)})
    with pytest.raises(ValueError):
        mgr.restore({"x": np.zeros((5,))})


def test_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    mgr.save(7, _state(7), block=False)
    mgr.wait()
    assert mgr.latest_step() == 7


# ------------------------------------------------------- across the packages


class _State(NamedTuple):
    step: object
    params: object
    opt_state: object


def _cases(seed):
    """The same state as numpy arrays: a dict, and a NamedTuple holding a
    dict, a list and None (an empty subtree in both packages)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((4, 3)).astype(np.float32)
    b = rng.standard_normal(3).astype(np.float32)
    m = [rng.standard_normal(3).astype(np.float32), np.arange(4, dtype=np.int32)]
    return {
        "dict": {"params": {"w": w, "b": b}, "opt": {"m": m[0], "step": np.int32(7)}},
        "namedtuple": _State(step=np.int32(3), params={"w": w, "b": b},
                             opt_state={"m": m, "v": None}),
    }


def _as(kind, tree):
    """``tree`` with its arrays as jax arrays or torch tensors."""
    if isinstance(tree, dict):
        return {k: _as(kind, v) for k, v in tree.items()}
    if isinstance(tree, _State):
        return _State(*(_as(kind, v) for v in tree))
    if isinstance(tree, list):
        return [_as(kind, v) for v in tree]
    if tree is None:
        return None
    return jnp.asarray(tree) if kind == "jax" else torch.from_numpy(np.array(tree))


def _manifest(path):
    with open(os.path.join(path, "step_00000001", "manifest.json")) as f:
        return json.load(f)["leaves"]


@pytest.mark.parametrize("case", ["dict", "namedtuple"])
def test_checkpoints_cross_the_packages(tmp_path, case):
    """A reference checkpoint restores into the port's torch template and a
    port checkpoint into the reference's numpy template: the same leaf
    names, shapes and dtypes in both manifests, the same arrays back."""
    state = _cases(0)[case]
    RefManager(str(tmp_path / "ref")).save(1, _as("jax", state))
    CheckpointManager(str(tmp_path / "port")).save(1, _as("torch", state))
    ref_m, port_m = _manifest(str(tmp_path / "ref")), _manifest(str(tmp_path / "port"))
    assert ref_m == port_m
    assert [e["name"] for e in port_m] == [n for n, _ in flatten_with_names(state)]
    expected = [np.asarray(x) for x in jax.tree.leaves(state)]

    template = _as("torch", _cases(1)[case])
    got = CheckpointManager(str(tmp_path / "ref")).restore(template)
    assert type(got) is type(template)
    for e, g in zip(expected, _leaves(got)):
        assert isinstance(g, torch.Tensor)
        np.testing.assert_array_equal(g.numpy(), e)

    back = RefManager(str(tmp_path / "port")).restore(
        jax.tree.map(np.zeros_like, _cases(1)[case]))
    for e, g in zip(expected, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(g), e)
    flat = CheckpointManager(str(tmp_path / "ref")).restore_flat()
    assert list(flat) == [e["name"] for e in ref_m]
