"""The port's invariant auditor (``repro_torch.analysis``) on the CPU: a
counterpart of each of the reference's 19 programs with the same invariant
IDs, every one clean against its budgets and the committed baseline, each
seeded violation caught, the gate script's exit codes and its drift check,
and the materialization and dtype checks held beside the reference's."""
import importlib.util
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

from repro_torch.analysis import (  # noqa: E402
    MaterializationBudget,
    ProgramSpec,
    all_programs,
    audit_program,
    get_program,
)
from repro_torch.analysis.violations import VIOLATIONS, stacked_basis_data  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BASELINE = ROOT / "src" / "repro_torch" / "analysis" / "baseline.json"
PORT_NAMES = sorted(s.name for s in all_programs())


def _gate():
    spec = importlib.util.spec_from_file_location(
        "torch_analysis_gate", ROOT / "scripts" / "torch_analysis_gate.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def gate_reports():
    """One audit of every program, shared by the gate's runs below."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return _gate().run_audits(None, torch.device("cpu"))
    finally:
        torch.set_num_threads(prev)


def _reference_programs() -> dict:
    """name → invariant IDs of the reference's registry (registration does
    not build or trace anything)."""
    from repro.analysis.registry import all_programs as ref_programs

    return {s.name: set(s.invariants) for s in ref_programs()}


def test_every_reference_program_has_a_counterpart_with_its_invariants():
    ref = _reference_programs()
    assert len(ref) == 19
    want = {name.replace("_kernel_interpret", "_kernel"): ids for name, ids in ref.items()}
    assert set(PORT_NAMES) == set(want)
    for name, ids in want.items():
        assert set(get_program(name).invariants) == ids, name


@pytest.mark.parametrize("name", PORT_NAMES)
def test_program_audits_clean_against_the_baseline(name, gate_reports):
    rep = next(r for r in gate_reports if r["name"] == name)
    assert rep["device"] == "cpu" and rep["ok"], rep["failures"]
    base = json.loads(BASELINE.read_text())["programs"][name]
    assert rep["metrics"] == base


@pytest.mark.parametrize("name", sorted(VIOLATIONS))
def test_seeded_violation_is_detected(name):
    rep = audit_program(VIOLATIONS[name], device="cpu")
    assert not rep["ok"] and rep["failures"]
    check = {"extra_psum": "collective census", "stacked_basis": "materialization",
             "f64_promotion": "dtype audit", "missing_donation": "state audit",
             "host_callback": "host audit"}[name]
    assert all(f.startswith(check) for f in rep["failures"]), rep["failures"]


def test_gate_exit_codes_and_drift(gate_reports, tmp_path, monkeypatch):
    gate = _gate()
    monkeypatch.chdir(ROOT)
    monkeypatch.setattr(gate, "run_audits", lambda names, device: gate_reports)
    out = ["--device", "cpu", "--report-dir", str(tmp_path)]
    assert gate.main(out) == 0
    report = json.loads((tmp_path / "TORCH_ANALYSIS_report.json").read_text())
    assert report["failures"] == [] and len(report["programs"]) == 19
    # drift: one metric of a copy of the baseline changed
    base = json.loads(BASELINE.read_text())
    base["programs"]["two_pass_pass1_sharded"]["collectives"]["fold"] = 2
    drifted = tmp_path / "baseline.json"
    drifted.write_text(json.dumps(base))
    assert gate.main(out + ["--baseline", str(drifted)]) == 1
    assert gate.diff_baseline(gate_reports, str(drifted)) == [
        "two_pass_pass1_sharded: metric collectives drifted: baseline "
        + repr(base["programs"]["two_pass_pass1_sharded"]["collectives"]) + " → measured "
        + repr(next(r for r in gate_reports
                    if r["name"] == "two_pass_pass1_sharded")["metrics"]["collectives"])]
    # a missing program is drift too
    del base["programs"]["gram_kernel"]
    drifted.write_text(json.dumps(base))
    assert gate.main(out + ["--baseline", str(drifted)]) == 1
    assert gate.main(out + ["--seed-violation", "host_callback"]) == 1
    assert gate.main(out + ["--seed-violation", "no_such_violation"]) == 2


def _basis_spec(rows):
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.core.mctm import MCTMConfig, basis_features

    Y = stacked_basis_data()
    cfg, scaler = MCTMConfig(J=2, degree=3), DataScaler.fit(Y)
    return ProgramSpec(
        name=f"featurize_{rows}", description="",
        build=lambda dev, mesh: ((lambda y: basis_features(cfg, scaler, y)),
                                 (torch.as_tensor(Y[:rows], device=dev),)),
        materialization=MaterializationBudget(row_elems=2, fixed_elems=2048),
        kernels=(("bernstein", 1),))


def test_materialization_agrees_with_the_reference():
    """Both checks flag the whole-n featurize of ``stacked_basis``'s seeded Y
    and pass the chunked one."""
    import jax

    from repro.analysis.checks import ProgramArtifacts, check_materialization
    from repro.analysis.registry import MaterializationBudget as RefBudget
    from repro.analysis.registry import ProgramSpec as RefSpec
    from repro.analysis.violations import VIOLATIONS as REF_VIOLATIONS
    from repro.core.bernstein import DataScaler as RefScaler
    from repro.core.mctm import MCTMConfig as RefConfig
    from repro.core.mctm import basis_features as ref_basis

    ref_stacked = REF_VIOLATIONS["stacked_basis"]
    _, ref_fail = check_materialization(ref_stacked, ProgramArtifacts(ref_stacked).jaxpr)
    Y = stacked_basis_data()
    np.testing.assert_array_equal(ref_stacked.build()[1][0], Y)  # the same seeded Y
    cfg, scaler = RefConfig(J=2, degree=3), RefScaler.fit(Y)
    ref_chunk = RefSpec(name="chunk", description="",
                        build=lambda: (jax.jit(lambda y: ref_basis(cfg, scaler, y)), (Y[:32],)),
                        materialization=RefBudget(row_elems=2, fixed_elems=2048))
    _, ref_chunk_fail = check_materialization(ref_chunk, ProgramArtifacts(ref_chunk).jaxpr)
    port_stacked = audit_program(VIOLATIONS["stacked_basis"], device="cpu")
    port_whole = audit_program(_basis_spec(len(Y)), device="cpu")
    port_chunk = audit_program(_basis_spec(32), device="cpu")
    assert ref_fail and not ref_chunk_fail
    for rep in (port_stacked, port_whole):
        assert not rep["ok"]
        assert all(f.startswith("materialization") for f in rep["failures"])
        assert "[1024, 2, 4]" in " ".join(rep["failures"])
    assert port_chunk["ok"], port_chunk["failures"]


def _dtype_spec(scale):
    def build(dev, mesh):
        X = torch.ones((32, 8), device=dev)
        c = scale.to(dev)
        return (lambda x: torch.sum(x * c)), (X,)

    return ProgramSpec(name="dtype", description="", build=build)


def test_a_float64_scalar_passes_and_a_float64_vector_fails():
    scalar = audit_program(_dtype_spec(torch.tensor(1.5, dtype=torch.float64)), device="cpu")
    assert scalar["ok"], scalar["failures"]
    vector = audit_program(_dtype_spec(torch.from_numpy(np.full(8, 1.5))), device="cpu")
    assert not vector["ok"] and vector["failures"][0].startswith("dtype audit")
    assert vector["metrics"]["f64_arrays"] == 1
