"""The port's data mesh (``repro_torch.distributed``, ``launch.mesh``,
``launch.stages.data_mesh``) and the driver on it.

- A world of 1 needs no process group: every collective is the identity,
  with no copy and no count.
- A spawned gloo world of 2 on the CPU: the fold sums each part in rank
  order in its own dtype (every rank the same bits), one collective a fold;
  ragged row gathers, ``host_gather``, ``kv_allreduce``; a segmented
  scoring sweep crashed by ``FailureSimulator`` in its second segment and
  resumed to the uninterrupted bits (two-pass and one-pass), another layout
  refused on resume; an adam fit crashed at step 5 rolled back to rank 0's
  step-4 checkpoint, to the straight fit's bits; a kv exchange whose peer
  never arrives raises ``RuntimeError`` after ``kv_timeout_ms``.
- The driver: ``train_mctm --device cpu --fake-devices 2 --n 10001 --smoke``
  (one coreset size, 20 steps) against world 1: the full fit's NLL/pt
  within 3e-5, the limit test_torch_lbfgs.py holds the two packages' drivers
  to.
"""
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.distributed import DataMesh, host_gather, init_mesh, kv_allreduce, run_world  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import stages  # noqa: E402
from torch_mesh_ranks import dead_peer, mesh_all  # noqa: E402


def test_world_one_collectives_are_the_identity():
    mesh = DataMesh(device="cpu")
    parts = [torch.ones(3), None, torch.zeros(2, dtype=torch.float64)]
    got = mesh.fold(parts)
    assert all(a is b for a, b in zip(got, parts))
    x = torch.arange(5.0)
    assert mesh.all_gather(x, "fold").shape == (1, 5)
    assert torch.equal(mesh.gather_rows(x, 8, 4), x[:4])
    assert mesh.fold_host(np.ones(2)).tolist() == [1.0, 1.0]
    tree = {"a": np.ones(2)}
    assert kv_allreduce(tree, mesh) is tree
    np.testing.assert_array_equal(host_gather(np.arange(3), mesh), np.arange(3))
    assert mesh.share("x") == "x"
    mesh.barrier()
    assert mesh.census == {} and mesh.world == 1


def test_mesh_shapes_and_refusals(monkeypatch):
    with pytest.raises(ValueError, match="process group"):
        DataMesh(world=2, device="cpu")
    with pytest.raises(ValueError, match="data axes"):
        DataMesh(world=2, group=object(), device="cpu").check_axis(("pod", "data"))
    with pytest.raises(ValueError, match="backend"):
        DataMesh(backend="mpi", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        init_mesh(0, 1, backend="mpi", device="cpu", init_method="file:///nonexistent")
    with pytest.raises(ValueError, match="NCCL"):
        init_mesh(0, 1, backend="nccl", device="cpu", init_method="file:///nonexistent")
    pod = DataMesh(world=4, group=object(), axes=("pod", "data"), device="cpu")
    assert LM.data_axes(pod) == ("pod", "data")
    pod.check_axis(("pod", "data"))
    with pytest.raises(ValueError, match="data axes"):
        pod.check_axis("data")
    mesh = stages.data_mesh(device="cpu")
    assert mesh.world == 1 and mesh.group is None and LM.data_axes(mesh) == ("data",)
    assert LM.make_host_mesh(device="cpu").world == 1
    with pytest.raises(NotImplementedError, match="Queue A 11"):
        LM.make_host_mesh(model=2, device="cpu")
    # the production meshes are fake worlds (rank 0 of 16 or 32 data shards)
    for multi_pod, shards, chips, axes in ((False, 16, 256, ("data",)),
                                           (True, 32, 512, ("pod", "data"))):
        prod = LM.make_production_mesh(multi_pod=multi_pod)
        try:
            assert (prod.world, prod.rank, prod.chips, LM.data_axes(prod)) == (
                shards, 0, chips, axes)
            assert prod.fold([torch.ones(2)])[0].shape == (2,)
            assert prod.calls("fold") == 1
        finally:
            prod.close()
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match="gloo"):
        stages.data_mesh(device="cpu")


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    scratch = str(tmp_path_factory.mktemp("mesh_world"))
    return run_world(mesh_all, 2, backend="gloo", devices=["cpu"] * 2, args=(scratch,),
                     timeout_s=300)


def test_fold_is_rank_ordered_and_the_same_on_every_rank(world2):
    f32, none, f64, i64 = world2[0]["fold"]
    assert none is None
    np.testing.assert_array_equal(f32, (np.full(3, np.float32(0.1)) + np.float32(0.2)))
    assert f64[0] == 1e-17 + 2e-17 and f64.dtype == np.float64
    np.testing.assert_array_equal(i64, np.arange(4) * 3)
    for a, b in zip(world2[0]["fold"], world2[1]["fold"]):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert world2[0]["fold_calls"] == 1


def test_row_gathers_and_host_exchange(world2):
    for got in world2:
        np.testing.assert_array_equal(got["rows"], [0.0, 0.0, 0.0, 10.0])
        np.testing.assert_array_equal(got["host"], [0, 0, 1])
        np.testing.assert_array_equal(got["kv"]["a"], [3.0, 3.0])
        np.testing.assert_array_equal(got["kv"]["b"], [0, 2, 4])
        assert got["share"] == "from 0"


@pytest.mark.parametrize("tag", ["two", "one"])
def test_crashed_segmented_sweep_resumes_to_the_same_bits(world2, tag):
    for got in world2:
        crashed, steps, scores, hull, gram = got[f"seg_{tag}"]
        assert crashed and steps == [4]
        assert scores and hull and gram
        assert got["layout_raises"]


def test_crashed_fit_resumes_from_rank_zero_checkpoint(world2):
    for got in world2:
        steps, losses, params, saved = got["fit_resume"]
        assert steps == [5] and losses and params
        assert saved and all(s.startswith("step_") for s in saved)


def test_a_peer_that_never_arrives_raises():
    """Its own world, so only this exchange runs on the short deadline."""
    got = run_world(dead_peer, 2, backend="gloo", devices=["cpu"] * 2, timeout_s=120,
                    env={"REPRO_FT_KV_TIMEOUT_MS": "2000"})
    status, waited = got[0]
    assert status == "raised" and 1.5 <= waited < 30.0
    assert got[1] == "slept"


def test_kv_allreduce_takes_its_own_deadline():
    """``timeout_ms=`` overrides ``kv_timeout_ms`` for the call: the config's
    deadline is a minute, the call's 1.5 s."""
    got = run_world(dead_peer, 2, backend="gloo", devices=["cpu"] * 2, timeout_s=120,
                    args=(1500,), env={"REPRO_FT_KV_TIMEOUT_MS": "60000"})
    status, waited = got[0]
    assert status == "raised" and 1.0 <= waited < 3.4
    assert got[1] == "slept"


def test_driver_on_two_fake_devices_matches_world_one(tmp_path):
    from repro_torch.launch import train_mctm

    argv = ["--device", "cpu", "--n", "10001", "--smoke", "--ks", "200", "--steps", "20"]
    one = train_mctm.main(argv + ["--out", str(tmp_path / "w1.json")])
    two = train_mctm.main(argv + ["--fake-devices", "2", "--out", str(tmp_path / "w2.json")])
    assert one["devices"] == 1 and two["devices"] == 2 and two["backend"] == "gloo"
    assert abs(two["full_nll_per_point"] - one["full_nll_per_point"]) <= 3e-5 * abs(
        one["full_nll_per_point"])
    assert os.path.exists(tmp_path / "w2.json")
