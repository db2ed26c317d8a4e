"""Structural rules of the port: it imports neither jax nor the JAX package,
its entry points never fall back to the CPU unasked, unknown backends raise,
and its DGP copy draws exactly what the reference's draws."""
import ast
import pathlib

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
              + sorted((ROOT / "scripts").glob("torch_*.py")) + [ROOT / "chip_smoke.py"])


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
    is none; they never carry on on the CPU. The pod dry runs
    (``launch/dryrun_coreset.py``, the LM's ``launch/dryrun.py``,
    ``launch.mesh.make_production_mesh`` and ``make_production_device_mesh``)
    are not among them: they trace
    rank 0's program on fake or meta tensors in a fake world, CPU-only by
    nature, as the reference's do on placeholder devices."""
    from repro_torch.core import bernstein as TB
    from repro_torch.core import coreset as TC
    from repro_torch.core import mctm as TM
    from repro_torch.core import mctm_fit as TF
    from repro_torch.core import scoring as TS
    from repro_torch.configs import get_reduced_config
    from repro_torch.launch import train as lm_train
    from repro_torch.launch import train_mctm
    from repro_torch.models import build_model, model_from_jax
    from repro_torch.data.pipeline import CoresetSelector
    from repro_torch.launch import serve_mctm
    from repro_torch.distributed import DataMesh, run_world
    from repro_torch.launch.stages import data_mesh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.serve import DensityServeEngine, ServeEngine
    from repro_torch.analysis import audit_program, get_program
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_analysis_gate",
                                                  ROOT / "scripts" / "torch_analysis_gate.py")
    gate = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gate)
    monkeypatch.chdir(ROOT)

    lm_cfg = get_reduced_config("tinyllama_1b")
    cpu_model = build_model(lm_cfg, device="cpu")
    np_params = {
        "emb": {k: v.float().numpy() for k, v in cpu_model.emb.items()},
        "layers": {part: {k: np.stack([getattr(layer, part)[k].float().numpy()
                                       for layer in cpu_model.layers])
                          for k in getattr(cpu_model.layers[0], part)}
                   for part in ("ln_attn", "ln_mlp", "attn", "mlp")},
        "ln_f": {k: v.float().numpy() for k, v in cpu_model.ln_f.items()},
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TM.MCTMConfig(J=2)
    Y = np.random.default_rng(0).normal(size=(50, 2)).astype(np.float32)
    scaler = TB.DataScaler.fit(Y)
    from repro_torch.core import conditional as TCo
    from repro_torch.core import hull as TH
    from repro_torch.core import leverage as TL
    from repro_torch.core import streaming as TSt

    ccfg = TCo.CMCTMConfig(J=2, n_features=1)
    Xc = Y[:, :1]
    full = TM.FitResult(params=TM.init_params(cfg, device="cpu"), losses=np.zeros(0),
                        final_nll=0.0)
    calls = [
        lambda: TCo.fit_cmctm(ccfg, scaler, Y, Xc, steps=1),
        lambda: TCo.conditional_coreset_scores(ccfg, scaler, Y, Xc),
        lambda: TCo.build_conditional_coreset(ccfg, scaler, Y, Xc, 10,
                                              generator=torch.Generator()),
        lambda: TCo.init_cparams(ccfg),
        lambda: TL.leverage_scores_gram(Y),
        lambda: TL.leverage_scores_qr(Y),
        lambda: TL.ridge_leverage_scores(Y),
        lambda: TL.root_leverage_scores(Y),
        lambda: TL.sketched_leverage(Y, 8, generator=torch.Generator()),
        lambda: TH.greedy_hull_projection(Y, Y[0]),
        lambda: TH.epsilon_kernel_indices(Y, 10, generator=torch.Generator()),
        lambda: TM.sample(cfg, full.params, scaler, 5, generator=torch.Generator()),
        lambda: TC.evaluate_coreset(cfg, scaler, Y, full, 10, "uniform",
                                    generator=torch.Generator()),
        lambda: TS.ScoringEngine(cfg, scaler),
        lambda: TC.build_coreset(cfg, scaler, Y, 10, generator=torch.Generator()),
        lambda: TF.fit_mctm_streaming(cfg, scaler, Y, steps=1),
        lambda: TF.streamed_nll(cfg, scaler, TM.init_params(cfg, device="cpu"), Y),
        lambda: TM.init_params(cfg),
        lambda: train_mctm.main(["--n", "100", "--ks", "10", "--steps", "1"]),
        lambda: DataMesh(),
        lambda: data_mesh(),
        lambda: make_host_mesh(),
        lambda: make_host_mesh(model=2),
        lambda: run_world(print, 2, backend="gloo"),
        lambda: train_mctm.main(["--n", "100", "--ks", "10", "--steps", "1",
                                 "--inject-failures"]),
        lambda: TF.fit_density_model(TF.MCTMDensityModel(cfg, scaler),
                                     TM.init_params(cfg, device="cpu"),
                                     {"Y": Y, "weights": np.ones(50, np.float32)},
                                     steps=1, method="lbfgs"),
        lambda: TSt.MergeReduceCoreset(cfg, scaler, 10),
        lambda: TSt.StreamingCoresetMaintainer(cfg, scaler, 10, policy="sliding", window=2),
        lambda: TSt.drift_window_nll(cfg, scaler, TM.init_params(cfg, device="cpu"), Y),
        lambda: build_model(lm_cfg),
        lambda: model_from_jax(lm_cfg, np_params),
        lambda: ServeEngine(cpu_model),
        lambda: CoresetSelector(lambda rows: rows),
        lambda: DensityServeEngine(cfg, TM.init_params(cfg, device="cpu"), scaler),
        lambda: serve_mctm.main(["--smoke"]),
        lambda: TF.fit_mctm_streaming(cfg, scaler, Y, steps=1, method="minibatch",
                                      batch_size=8),
        lambda: lm_train.main(["--arch", "tinyllama-1.1b", "--reduced", "--steps", "1"]),
        lambda: build_model(lm_cfg, train=True),
        lambda: audit_program(get_program("streamed_nll_chunk")),
        lambda: gate.main([]),
        lambda: gate.main(["--seed-violation", "extra_psum"]),
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


def _lm_cache_case(branch):
    """A reduced tinyllama on the CPU and an attention call down ``branch``."""
    from repro_torch.configs import get_reduced_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    cfg = get_reduced_config("tinyllama_1b").replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    attn = model.layers[0].attn
    cache = model.init_cache(1, 16)
    lc = {"k": cache["k"][0], "v": cache["v"][0], "pos": torch.tensor(3, dtype=torch.int32)}
    x = torch.zeros(1, 4, cfg.d_model)
    pos = torch.arange(4)
    if branch == "prefill_into_nonempty_cache":
        return lambda: L.attention_apply(attn, x, cfg, positions=pos, cache=lc)
    if branch == "per_slot_multi_token":
        lc["pos"] = torch.zeros(1, dtype=torch.int32)
        return lambda: L.attention_apply(attn, x, cfg, positions=pos[None], cache=lc)
    if branch == "no_cache":
        return lambda: L.attention_apply(attn, x, cfg, positions=pos)
    if branch == "local_window":
        return lambda: L.attention_apply(attn, x[:, :1], cfg, positions=pos[:1], cache=lc, window=8)
    if branch == "softcap":
        return lambda: L.attention_apply(attn, x[:, :1], cfg.replace(logits_softcap=30.0),
                                         positions=pos[:1], cache=lc)
    if branch == "mla":
        return lambda: L.attention_apply(attn, x[:, :1], cfg.replace(attn_type="mla"),
                                         positions=pos[:1], cache=lc)
    if branch == "bidirectional":
        return lambda: L.attention_apply(attn, x, cfg, positions=pos, cache=lc, bidirectional=True)
    raise AssertionError(branch)


@pytest.mark.parametrize("what", [
    "config:gemma_2b", "config:whisper-medium", "reduced:minicpm3_4b", "reduced:arctic_480b",
    "reduced:recurrentgemma_2b", "reduced:phi3_vision_4b",
    "family:moe", "family:hybrid", "family:encdec", "modality:vision",
    "attention:prefill_into_nonempty_cache", "attention:per_slot_multi_token",
    "attention:no_cache", "attention:local_window", "attention:softcap", "attention:mla",
    "attention:bidirectional", "streaming:serve_engine", "streaming:drift_mesh",
    "streaming:mesh",
])
def test_unported_parts_raise_not_implemented(what):
    """What the port does not carry raises NotImplementedError naming the
    ROADMAP item — never plain code on a detour around a kernel. The
    maintainer's ``serve_engine=`` and ``drift_mesh=`` and
    ``drift_window_nll(mesh=)`` are ported now, and so are attention without
    a cache (training) and prefill into a non-empty cache (chunked
    prefill), and so are MLA (minicpm3), MoE (qwen2-moe, arctic) and the
    hybrid with local attention over a ring cache (recurrentgemma), and so
    are gemma-2b, whisper-medium (the encdec family, bidirectional
    attention), the vision prefix (phi3-vision) and soft-capped attention:
    their cases check that they are taken (``attention_apply`` stays the
    GQA path and refuses an MLA config, which goes through ``mla_apply``)."""
    from repro_torch import configs
    from repro_torch.core import mctm as TM
    from repro_torch.core import streaming as TSt
    from repro_torch.core.bernstein import DataScaler
    from repro_torch.models import build_model

    if what.startswith("streaming:"):
        # ported (the drift → refit loop, and its mesh): the maintainer takes
        # a serving engine and a drift mesh, and drift_window_nll a mesh (a
        # world of 1: the same float as without one)
        from repro_torch.core import mctm as TM
        from repro_torch.core import streaming as TSt
        from repro_torch.core.bernstein import DataScaler
        from repro_torch.serve.density import DensityServeEngine

        cfg = TM.MCTMConfig(J=2)
        Y = np.random.default_rng(0).normal(size=(20, 2)).astype(np.float32)
        scaler = DataScaler.fit(Y)
        eng = DensityServeEngine(cfg, TM.init_params(cfg, device="cpu"), scaler, device="cpu")
        m = TSt.StreamingCoresetMaintainer(cfg, scaler, 8, device="cpu", serve_engine=eng,
                                           detector=TSt.DriftDetector())
        from repro_torch.distributed import DataMesh

        mesh = DataMesh(device="cpu")
        if what == "streaming:serve_engine":
            assert m.serve_engine is eng
        elif what == "streaming:drift_mesh":
            m = TSt.StreamingCoresetMaintainer(cfg, scaler, 8, device="cpu", serve_engine=eng,
                                               drift_mesh=mesh)
            assert m.drift_mesh is mesh
        else:
            p = TM.init_params(cfg, device="cpu")
            assert TSt.drift_window_nll(cfg, scaler, p, Y, mesh=mesh) == \
                TSt.drift_window_nll(cfg, scaler, p, Y, device="cpu")
        return
    if what in ("attention:no_cache", "attention:prefill_into_nonempty_cache"):
        # ported (the training forward, chunked prefill): plain attention,
        # no cache returned without one, the cache advanced past pos 3 with one
        out, new_cache = _lm_cache_case(what.split(":")[1])()
        assert out.shape == (1, 4, 64) and torch.isfinite(out).all()
        if what == "attention:no_cache":
            assert new_cache is None
        else:
            assert int(new_cache["pos"]) == 7
        return
    if what == "attention:local_window":
        # ported: a decode step into a ring cache of the window's length
        cfg = configs.get_reduced_config("tinyllama_1b").replace(dtype="float32")
        model = build_model(cfg, device="cpu")
        from repro_torch.models import layers as L

        lc = {"k": torch.zeros(1, 8, cfg.n_kv_heads, cfg.head_dim),
              "v": torch.zeros(1, 8, cfg.n_kv_heads, cfg.head_dim),
              "pos": torch.tensor(11, dtype=torch.int32)}
        x = torch.ones(1, 1, cfg.d_model)
        out, new_cache = L.attention_apply(model.layers[0].attn, x, cfg,
                                           positions=torch.arange(11, 12), cache=lc, window=8)
        assert out.shape == (1, 1, cfg.d_model) and torch.isfinite(out).all()
        assert int(new_cache["pos"]) == 12 and bool(new_cache["k"][0, 11 % 8].abs().sum() > 0)
        return
    if what in ("reduced:recurrentgemma_2b", "family:hybrid"):
        # ported: the hybrid builds, and a prefill and a decode through its
        # rec and local-attention blocks give finite logits
        cfg = configs.get_reduced_config("recurrentgemma_2b")
        assert cfg.family == "hybrid"
        model = build_model(cfg, device="cpu")
        cache = model.init_cache(1, 16)
        logits, cache = model.prefill({"tokens": np.arange(5)[None]}, cache)
        logits2, cache = model.decode_step(np.asarray([[3]]), cache)
        assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
        assert int(cache["pos"]) == 6 and sorted(cache) == ["groups", "pos", "tail"]
        return
    if what in ("reduced:minicpm3_4b", "reduced:arctic_480b", "family:moe"):
        # ported: the reduced config builds, and a prefill and a decode
        # through its MLA or MoE layers give finite logits
        arch = {"family:moe": "qwen2_moe_a2_7b"}.get(what, what.split(":")[1])
        cfg = configs.get_reduced_config(arch)
        assert cfg.family == ("moe" if "moe" in what or "arctic" in what else "dense")
        model = build_model(cfg, device="cpu")
        cache = model.init_cache(1, 16)
        logits, cache = model.prefill({"tokens": np.arange(5)[None]}, cache)
        logits2, cache = model.decode_step(np.asarray([[3]]), cache)
        assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
        assert int(cache["pos"]) == 6 and ("ckv" in cache) == (cfg.attn_type == "mla")
        return
    if what in ("config:gemma_2b", "config:whisper-medium"):
        # ported: the published configs (gemma-2b's MQA at head_dim 256,
        # whisper-medium's 24 + 24 layers)
        cfg = configs.get_config(what.split(":")[1])
        got = (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
        assert got == {"config:gemma_2b": ("dense", 18, 2048, 8, 1, 256),
                       "config:whisper-medium": ("encdec", 48, 1024, 16, 16, 64)}[what]
        return
    if what in ("reduced:phi3_vision_4b", "modality:vision"):
        # ported: the vision prefix, P patch positions before the text in
        # the prefill (the cache advances P + S), then a token decode
        cfg = (configs.get_reduced_config("phi3_vision_4b") if what.startswith("reduced")
               else configs.get_reduced_config("tinyllama_1b").replace(modality="vision",
                                                                       n_modality_positions=3))
        model = build_model(cfg, device="cpu")
        P = cfg.n_modality_positions
        cache = model.init_cache(1, 16)
        patches = np.full((1, P, cfg.d_model), 0.02, np.float32)
        logits, cache = model.prefill({"tokens": np.arange(5)[None], "patch_embeds": patches},
                                      cache)
        logits2, cache = model.decode_step(np.asarray([[3]]), cache)
        assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
        assert int(cache["pos"]) == P + 6
        return
    if what == "family:encdec":
        # ported: the reduced whisper builds, its prefill encodes the frames
        # and installs cross K/V of their length, and a decode step follows
        from repro_torch.models import EncDecModel

        cfg = configs.get_reduced_config("whisper_medium")
        model = build_model(cfg, device="cpu")
        assert isinstance(model, EncDecModel)
        cache = model.init_cache(1, 16)
        frames = np.full((1, 10, cfg.d_model), 0.02, np.float32)
        logits, cache = model.prefill({"frames": frames, "tokens": np.arange(5)[None]}, cache)
        logits2, cache = model.decode_step(np.asarray([[3]]), cache)
        assert torch.isfinite(logits).all() and torch.isfinite(logits2).all()
        assert int(cache["pos"]) == 6 and cache["cross_k"].shape[2] == 10
        return
    if what == "attention:softcap":
        # ported: a soft-capped decode step over the cache
        out, new_cache = _lm_cache_case("softcap")()
        assert out.shape == (1, 1, 64) and torch.isfinite(out).all()
        assert int(new_cache["pos"]) == 4
        return
    if what == "attention:bidirectional":
        # ported: without a cache every key is attended (the kernel's plain
        # version on the CPU); with a cache the reference ignores it, and so
        # does the port
        from repro_torch.models import layers as L

        cfg = configs.get_reduced_config("tinyllama_1b").replace(dtype="float32")
        attn = build_model(cfg, device="cpu").layers[0].attn
        x = torch.randn(1, 4, cfg.d_model, generator=torch.Generator().manual_seed(0))
        pos = torch.arange(4)
        full, _ = L.attention_apply(attn, x, cfg, positions=pos, bidirectional=True)
        causal, _ = L.attention_apply(attn, x, cfg, positions=pos)
        assert torch.allclose(full[:, -1], causal[:, -1], atol=1e-5)
        assert not torch.allclose(full[:, 0], causal[:, 0], atol=1e-3)
        out, new_cache = _lm_cache_case("bidirectional")()
        ref, _ = _lm_cache_case("prefill_into_nonempty_cache")()
        assert torch.equal(out, ref) and int(new_cache["pos"]) == 7
        return
    if what == "attention:mla":
        # attention_apply is the GQA path: an MLA config is refused there
        # and routed through mla_apply by the layer
        with pytest.raises(NotImplementedError, match="mla_apply"):
            _lm_cache_case("mla")()
        return
    kind, arg = what.split(":")
    tiny = configs.get_reduced_config("tinyllama_1b")
    mcfg = TM.MCTMConfig(J=2)
    Y = np.random.default_rng(0).normal(size=(20, 2)).astype(np.float32)
    scaler = DataScaler.fit(Y)

    call = {
        "config": lambda: configs.get_config(arg),
        "reduced": lambda: configs.get_reduced_config(arg),
        "family": lambda: build_model(tiny.replace(family=arg), device="cpu"),
        "modality": lambda: build_model(tiny.replace(modality=arg), device="cpu"),
        "attention": lambda: _lm_cache_case(arg)(),
    }[kind]
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        call()


def test_ctypes_signatures_match_the_exported_functions():
    """Every function ``csrc/*.cu`` exports has an argtypes entry in
    ``kernels/_lib.py`` with as many arguments as its C declaration (a
    mismatch shows only on the card, where the library is built)."""
    import re

    from repro_torch.kernels import _lib

    exported = {}
    for src in sorted(_lib.CSRC.glob("*.cu")):
        for name, params in re.findall(r"REPRO_EXPORT\s+int\s+(repro_\w+)\(([^)]*)\)",
                                       src.read_text()):
            exported[name] = len([p for p in params.split(",") if p.strip()])
    assert set(exported) == set(_lib._SIGNATURES)
    for name, n in exported.items():
        assert len(_lib._SIGNATURES[name]) == n, name


def _cuda_int_constants(text: str) -> dict:
    """The integer ``#define``s and ``constexpr int``s of a CUDA source, each
    evaluated from the ones before it."""
    import re

    found = {}
    pattern = r"^\s*(?:#define\s+(\w+)\s+([^\n/]+)|constexpr int (\w+) = ([^;]+);)"
    for d_name, d_expr, c_name, c_expr in re.findall(pattern, text, flags=re.M):
        try:
            found[d_name or c_name] = int(eval(d_expr or c_expr, {"__builtins__": {}}, dict(found)))
        except (NameError, SyntaxError, TypeError):
            pass  # a macro with arguments, or a value that is no integer
    return found


def test_cuda_constants_match_the_sources():
    """The limits and launch units that the wrappers check and plan with
    (``_lib.CUDA_CONSTANTS``) are those of ``csrc/``: a mismatch would show
    only on the card, as a refused launch or a slower plan."""
    from repro_torch.kernels import _lib

    for src, table in _lib.CUDA_CONSTANTS.items():
        found = _cuda_int_constants((_lib.CSRC / src).read_text())
        for name, value in table.items():
            assert found.get(name) == value, (src, name, found.get(name), value)


# Names of the reference's public API that the port does not carry, each
# with its reason. jax only (ROADMAP Queue A, "not ported by design"): the
# factories of jitted shard_map bodies, the backend selectors and block
# sizes of the Pallas wrappers, and the JAX PRNG-key helpers of
# ``utils/prng.py`` (the port draws from ``torch.Generator``s, which have no
# keys to split or fold).
_EXPORT_WAIVERS = {
    "core.distributed_coreset": {"make_sharded_pass_fns", "make_sharded_onepass_fn",
                                 "make_segmented_pass_fns", "make_segmented_onepass_fn"},
    "core.streaming": {"make_sharded_drift_nll_fn"},
    "kernels.extremes": {"default_extremes_backend"},
    "kernels.sweep.ops": {"DEFAULT_BLOCK_ROWS", "default_sweep_backend"},
    "utils": {"key_iter", "fold_in_str"},
}


def _reference_exports(path: pathlib.Path) -> set:
    """The reference module's ``__all__``, read from its source (no jax
    import); empty where it has none."""
    for node in ast.parse(path.read_text()).body:
        if (isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name)
                and node.targets[0].id == "__all__"):
            return set(ast.literal_eval(node.value))
    return set()


def _exported_modules() -> list[str]:
    """The port's modules and packages whose reference counterpart has an
    ``__all__``, dotted below ``repro_torch``."""
    out = []
    port_root = ROOT / "src" / "repro_torch"
    for path in sorted(port_root.rglob("*.py")):
        rel = path.relative_to(port_root)
        ref = ROOT / "src" / "repro" / rel
        if ref.exists() and _reference_exports(ref):
            parts = rel.with_suffix("").parts
            out.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    return out


@pytest.mark.parametrize("mod", _exported_modules())
def test_exports_match_the_reference(mod):
    """Every name the reference's module or package exports, the port's
    ``__all__`` exports and resolves, but for the waivers; a waiver names a
    reference export the port still lacks (a name that lands leaves the list)."""
    import importlib

    rel = pathlib.Path(*mod.split("."))
    ref_path = ROOT / "src" / "repro" / rel / "__init__.py"
    if not ref_path.exists():
        ref_path = (ROOT / "src" / "repro" / rel).with_suffix(".py")
    ref = _reference_exports(ref_path)
    port = importlib.import_module(f"repro_torch.{mod}")
    exported = set(getattr(port, "__all__", ()))
    waived = _EXPORT_WAIVERS.get(mod, set())
    assert waived <= ref and not waived & exported, (mod, waived - ref, waived & exported)
    missing = ref - waived - exported
    assert not missing, (mod, sorted(missing))
    for name in sorted(ref - waived):
        assert getattr(port, name) is not None, (mod, name)


def test_every_export_waiver_names_an_exporting_module():
    assert set(_EXPORT_WAIVERS) <= set(_exported_modules())
