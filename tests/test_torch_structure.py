"""Structural rules of the port: it imports neither jax nor the JAX package,
its entry points never fall back to the CPU unasked, unknown backends raise,
and its DGP copy draws exactly what the reference's draws."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"


def test_entry_points_refuse_a_missing_card(monkeypatch):
    """Without device=, the entry points ask for CUDA and raise where there
    is none; they never carry on on the CPU."""
    from repro_torch.core import bernstein as TB
    from repro_torch.core import coreset as TC
    from repro_torch.core import mctm as TM
    from repro_torch.core import mctm_fit as TF
    from repro_torch.core import scoring as TS
    from repro_torch.launch import train_mctm

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TM.MCTMConfig(J=2)
    Y = np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32)
    scaler = TB.DataScaler.fit(Y)
    calls = [
        lambda: TS.ScoringEngine(cfg, scaler),
        lambda: TC.build_coreset(cfg, scaler, Y, 10, generator=torch.Generator()),
        lambda: TF.fit_mctm_streaming(cfg, scaler, Y, steps=1),
        lambda: TF.streamed_nll(cfg, scaler, TM.init_params(cfg, device="cpu"), Y),
        lambda: TM.init_params(cfg),
        lambda: train_mctm.main(["--n", "100", "--ks", "10", "--steps", "1"]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_unknown_names_raise():
    from repro_torch.core import coreset as TC
    from repro_torch.core import scoring as TS
    from repro_torch.kernels import gram

    with pytest.raises(ValueError, match="unknown gram backend"):
        gram.gram_matrix(torch.zeros(3, 2), backend="pallas")
    with pytest.raises(ValueError):
        TS.resolve_strategy("three-pass")
    with pytest.raises(ValueError):
        TC.coreset_scores(None, None, np.zeros((3, 2)), method="kmeans", device="cpu")


def test_dgp_copy_matches_reference():
    from repro.data.dgp import DGPS, generate
    from repro_torch.data.dgp import DGPS as TDGPS
    from repro_torch.data.dgp import generate as tgenerate

    assert tuple(TDGPS) == tuple(DGPS)
    for name in DGPS:
        np.testing.assert_array_equal(tgenerate(name, 64, seed=5), generate(name, 64, seed=5))
