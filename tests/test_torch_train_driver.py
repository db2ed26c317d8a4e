"""The LM training driver (``python -m repro_torch.launch.train``) on the
CPU at the reduced configs, with the coreset stage in front: finite and
falling losses; a run crashed at step 5 by the ft layer's injection and
resumed from its checkpoint gives the straight run's losses bit for bit;
the default architecture (olmo-1b, the reference's) runs."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import numpy as np  # noqa: E402

from repro_torch import ft  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ARGV = ["--device", "cpu", "--reduced", "--steps", "8", "--log-every", "0"]


@pytest.mark.parametrize("arch,coreset", [("tinyllama-1.1b", "l2-hull"),
                                          ("mamba2-370m", "uniform"),
                                          ("tinyllama-1.1b", "none"),
                                          ("qwen2-moe-a2.7b", "l2-hull"),
                                          ("recurrentgemma-2b", "l2-hull"),
                                          ("whisper-medium", "l2-hull"),
                                          ("phi-3-vision-4.2b", "none"),
                                          ("gemma-2b", "uniform")])
def test_driver_losses_fall(arch, coreset):
    rec = train.main(ARGV + ["--arch", arch, "--coreset", coreset])
    losses = np.asarray(rec["losses"])
    assert losses.shape == (8,) and np.isfinite(losses).all()
    assert losses[-3:].mean() < losses[:3].mean(), losses
    assert len(rec["step_s"]) == 8 and rec["select_s"] >= 0


def test_driver_resumes_a_crash_to_the_straight_bits(tmp_path):
    argv = ARGV + ["--arch", "tinyllama-1.1b", "--coreset", "l2-hull", "--ckpt-every", "2"]
    straight = train.main(argv + ["--ckpt-dir", str(tmp_path / "straight")])["losses"]
    crashed = argv + ["--ckpt-dir", str(tmp_path / "crashed")]
    with ft.ft_overrides(simulator=ft.FailureSimulator().inject("fit", 5)):
        with pytest.raises(ft.InjectedFailure):
            train.main(crashed)
    rec = train.main(crashed + ["--resume"])
    assert rec["start"] == 4
    assert rec["losses"] == straight[4:]


def test_unported_architecture_raises():
    """No architecture is left unported: with no ``--arch`` launch/train.py
    trains olmo-1b, the reference's default."""
    rec = train.main(["--device", "cpu", "--reduced", "--steps", "2", "--log-every", "0"])
    assert rec["arch"] == "olmo-1b" and np.isfinite(rec["losses"]).all()
