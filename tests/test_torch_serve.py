"""The port's ``ServeEngine`` against the JAX package's on the same weights
and prompts (reduced tinyllama, mamba2, minicpm3, qwen2-moe and arctic at
float32: greedy tokens must be equal — at bf16 a near-tie can flip an
argmax between two correct implementations), and the ports of
tests/test_serve.py's three tests."""
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_thread  # noqa: E402,F401

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.serve import GenerationConfig as JGen  # noqa: E402
from repro.serve import Request as JRequest  # noqa: E402
from repro.serve import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import build_model, model_from_jax  # noqa: E402
from repro_torch.serve import GenerationConfig, Request, ServeEngine  # noqa: E402


@pytest.fixture(scope="module")
def setup():
    cfg = get_reduced_config("tinyllama_1b").replace(dtype="float32")
    return cfg, build_model(cfg, device="cpu", seed=0)


def _greedy_reference(model, prompt, n_new, max_len):
    """Single-request greedy decode (the unbatched ground truth)."""
    cache = model.init_cache(1, max_len)
    logits, cache = model.prefill({"tokens": prompt[None, :]}, cache)
    toks = [int(np.argmax(logits[0, -1].numpy()))]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(np.asarray([[toks[-1]]], np.int32), cache)
        toks.append(int(np.argmax(logits[0, -1].numpy())))
    return toks


@pytest.mark.parametrize("name", ["tinyllama_1b", "mamba2_370m", "minicpm3_4b",
                                  "qwen2_moe_a2_7b", "arctic_480b", "olmo_1b", "gemma_2b"])
def test_engine_matches_jax_engine(name):
    jcfg = jax_config(name).replace(dtype="float32")
    jm = jax_build(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(1))
    tm = model_from_jax(get_reduced_config(name).replace(dtype="float32"),
                        jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(2)
    # mamba2's reduced chunk is 16: prompts of at most 16 tokens or multiples
    prompts = [rng.integers(0, jcfg.vocab_size, n).astype(np.int32) for n in (5, 16, 9, 32, 7)]
    jeng = JServeEngine(jm, params, n_slots=2, max_len=64)
    jeng.cache["pos"] = jnp.zeros((2,), jnp.int32)
    teng = ServeEngine(tm, n_slots=2, max_len=64, device="cpu")
    teng.cache["pos"] = torch.zeros(2, dtype=torch.int32)
    for i, p in enumerate(prompts):
        gen = dict(max_new_tokens=3 + i)
        jeng.submit(JRequest(uid=i, prompt=p, gen=JGen(**gen)))
        teng.submit(Request(uid=i, prompt=p, gen=GenerationConfig(**gen)))
    jdone = {r.uid: r.output for r in jeng.run_until_drained()}
    tdone = {r.uid: r.output for r in teng.run_until_drained()}
    assert tdone == jdone
    assert teng.ticks == jeng.ticks


@pytest.mark.parametrize("name", ["tinyllama_1b", "mamba2_370m", "minicpm3_4b"])
def test_finished_slot_past_the_cache_end_matches_jax_engine(name):
    """A finished slot keeps ticking until a new request takes it, so its
    pos runs past max_len while another slot decodes; its cache writes are
    dropped, as the reference's scatter drops them."""
    jcfg = jax_config(name).replace(dtype="float32")
    jm = jax_build(jcfg)
    params, _ = jm.init(jax.random.PRNGKey(3))
    tm = model_from_jax(get_reduced_config(name).replace(dtype="float32"),
                        jax.tree.map(np.asarray, params), device="cpu")
    rng = np.random.default_rng(4)
    max_len = 24
    # A: 12-token prompt, 3 tokens, then its slot idles; B: 4-token prompt,
    # 19 tokens (its last write at position 21). A's slot reaches pos 30.
    work = [(12, 3), (4, 19)]
    jeng = JServeEngine(jm, params, n_slots=2, max_len=max_len)
    jeng.cache["pos"] = jnp.zeros((2,), jnp.int32)
    teng = ServeEngine(tm, n_slots=2, max_len=max_len, device="cpu")
    teng.cache["pos"] = torch.zeros(2, dtype=torch.int32)
    for i, (n, new) in enumerate(work):
        p = rng.integers(0, jcfg.vocab_size, n).astype(np.int32)
        jeng.submit(JRequest(uid=i, prompt=p, gen=JGen(max_new_tokens=new)))
        teng.submit(Request(uid=i, prompt=p, gen=GenerationConfig(max_new_tokens=new)))
    jdone = {r.uid: r.output for r in jeng.run_until_drained()}
    tdone = {r.uid: r.output for r in teng.run_until_drained()}
    assert tdone == jdone and [len(tdone[i]) for i in range(2)] == [3, 19]
    assert int(teng.cache["pos"].max()) > max_len


def test_engine_matches_unbatched_greedy(setup):
    cfg, model = setup
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 7)]
    engine = ServeEngine(model, n_slots=2, max_len=48, device="cpu")
    # per-slot position vector
    engine.cache["pos"] = torch.zeros(2, dtype=torch.int32)
    reqs = [
        Request(uid=i, prompt=p, gen=GenerationConfig(max_new_tokens=6))
        for i, p in enumerate(prompts)
    ]
    for r in reqs:
        engine.submit(r)
    done = engine.run_until_drained()
    assert len(done) == 3
    for r in done:
        ref = _greedy_reference(model, r.prompt, 6, 48)
        assert r.output == ref, f"req {r.uid}: {r.output} vs {ref}"


def test_engine_recycles_slots(setup):
    cfg, model = setup
    rng = np.random.default_rng(1)
    engine = ServeEngine(model, n_slots=2, max_len=32, device="cpu")
    engine.cache["pos"] = torch.zeros(2, dtype=torch.int32)
    # 5 requests through 2 slots, mixed lengths
    for i in range(5):
        engine.submit(
            Request(
                uid=i,
                prompt=rng.integers(0, cfg.vocab_size, 4 + i).astype(np.int32),
                gen=GenerationConfig(max_new_tokens=3 + (i % 3)),
            )
        )
    done = engine.run_until_drained()
    assert sorted(r.uid for r in done) == [0, 1, 2, 3, 4]
    for r in done:
        assert len(r.output) == r.gen.max_new_tokens
    assert len(engine.prefill_seconds) == 5 and len(engine.tick_seconds) == engine.ticks


def test_engine_rejects_encdec(setup):
    """The engine refuses an encdec model (the reduced whisper) as the
    reference's does: a request needs its own encoder state, so whisper is
    served through the model's prefill and decode_step."""
    whisper = build_model(get_reduced_config("whisper_medium"), device="cpu")
    with pytest.raises(ValueError, match="encdec"):
        ServeEngine(whisper, device="cpu")


def test_engine_samples_with_an_explicit_generator(setup):
    cfg, model = setup
    prompt = np.arange(6, dtype=np.int32)
    outs = []
    for _ in range(2):
        engine = ServeEngine(model, n_slots=1, max_len=32, device="cpu",
                             generator=torch.Generator().manual_seed(5))
        engine.submit(Request(uid=0, prompt=prompt,
                              gen=GenerationConfig(max_new_tokens=5, temperature=1.0)))
        outs.append(engine.run_until_drained()[0].output)
    assert outs[0] == outs[1] and len(outs[0]) == 5
    engine = ServeEngine(model, n_slots=1, max_len=32, device="cpu")
    engine.submit(Request(uid=0, prompt=prompt, gen=GenerationConfig(temperature=1.0)))
    with pytest.raises(ValueError, match="Generator"):
        engine.run_until_drained()
