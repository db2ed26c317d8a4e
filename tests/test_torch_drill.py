"""The peer-death drill of ``tests/test_multiprocess.py``
(``test_kill_one_worker_survivor_recovers``) on the port: a gloo world of
two CPU ranks (``repro_torch.distributed.run_world``) in which rank 1 dies
with exit code 17 at step 7; rank 0's ``kv_allreduce`` raises the dead-peer
``RuntimeError``, its ``RunSupervisor`` retries once, restores its last
checkpoint and finishes degraded on all 64 rows, within the reference
drill's tolerance of the uninterrupted numpy run. ``run_world``'s survivor
mode (``expect_exit``) reports the death instead of raising; without it the
same world raises."""
import numpy as np
import pytest

pytest.importorskip("torch")

from torch_mesh_ranks import drill_reference, peer_death_drill  # noqa: E402

from repro_torch.distributed import RankExit, run_world  # noqa: E402

KV_TIMEOUT = {"REPRO_FT_KV_TIMEOUT_MS": "8000"}


def test_survivor_recovers_from_a_dead_peer(tmp_path):
    got = run_world(peer_death_drill, 2, backend="gloo", devices=["cpu"] * 2,
                    args=(str(tmp_path),), timeout_s=240, env=KV_TIMEOUT,
                    expect_exit={1: 17})
    assert got[1] == RankExit(1, 17)
    w, loss, events = got[0]
    assert len(events) == 1, events  # exactly one dead-peer retry
    assert events[0]["kind"] == "failure"
    w_ref, loss_ref = drill_reference()
    np.testing.assert_allclose(w, w_ref, rtol=5e-3, atol=1e-4)
    assert abs(loss - loss_ref) <= 5e-3 * max(abs(loss_ref), 1e-9), (loss, loss_ref)


def test_a_dead_peer_still_raises_without_expect_exit(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1: exited with code 17"):
        run_world(peer_death_drill, 2, backend="gloo", devices=["cpu"] * 2,
                  args=(str(tmp_path),), timeout_s=240, env=KV_TIMEOUT)


def test_an_expected_death_that_does_not_happen_raises(tmp_path):
    with pytest.raises(RuntimeError, match="expected to exit with code 17"):
        run_world(peer_death_drill, 2, backend="gloo", devices=["cpu"] * 2,
                  args=(str(tmp_path), None), timeout_s=240, env=KV_TIMEOUT,
                  expect_exit={1: 17})
