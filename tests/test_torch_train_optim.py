"""The port's synthetic token stream, schedules and optimizers against the
JAX package's: the stream's batches bit for bit over several (seed, step)
pairs; each schedule over its warmup and decay, and each optimizer (and the
chain of clipping and AdamW) run on the same gradients over 5 steps, its
updates, states and parameters within rel 1e-6 of the reference's (float32
arithmetic in the same order; sums over a leaf in another order)."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import one_thread  # noqa: E402,F401

from repro import optim as RO  # noqa: E402
from repro.data import synthetic_lm as RS  # noqa: E402
from repro_torch import optim as TO  # noqa: E402
from repro_torch.data import synthetic_lm as TS  # noqa: E402

REL = 1e-6
SHAPES = [(7,), (5, 6), (3, 4, 5), (1, 8), (8, 1), (2, 3, 1)]


@pytest.mark.parametrize("vocab,seq,batch", [(256, 32, 8), (32_000, 64, 4), (50_280, 17, 3)])
def test_sample_batch_matches_the_reference_bit_for_bit(vocab, seq, batch):
    for seed, step in [(0, 0), (0, 5), (3, 11), (7, 1_000)]:
        ref = RS.sample_batch(RS.TokenStreamConfig(vocab, seq), batch, step, seed)
        got = TS.sample_batch(TS.TokenStreamConfig(vocab, seq), batch, step, seed)
        assert set(got) == set(ref)
        for k in ref:
            assert got[k].dtype == ref[k].dtype and got[k].shape == ref[k].shape, k
            np.testing.assert_array_equal(got[k], ref[k])
    np.testing.assert_array_equal(TS.sample_modality_stub(2, 5, 16, 3),
                                  RS.sample_modality_stub(2, 5, 16, 3))


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-3,)),
    ("linear_warmup", (3e-3, 20)),
    ("linear_warmup", (0.1, 0)),
    ("cosine_warmup", (3e-3, 20, 100)),
    ("cosine_warmup", (1e-3, 5, 30, 0.0)),
])
def test_schedules_match_the_reference(name, args):
    ref, got = getattr(RO, name)(*args), getattr(TO, name)(*args)
    for step in range(0, 120, 3):
        r = np.asarray(ref(jnp.int32(step)))
        g = got(step)
        assert isinstance(g, np.float32), type(g)
        np.testing.assert_allclose(g, r, rtol=REL, atol=0)


def _close(got, ref, what):
    ref = np.asarray(ref, np.float64)
    got = got.detach().double().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=REL, atol=REL * max(float(np.abs(ref).max()), 1e-30),
                               err_msg=what)


def _close_tree(got, ref, what):
    if isinstance(ref, dict):
        assert set(got) == set(ref), what
        for k in ref:
            _close_tree(got[k], ref[k], f"{what}.{k}")
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), what
        for i, (g, r) in enumerate(zip(got, ref)):
            _close_tree(g, r, f"{what}[{i}]")
    else:
        _close(got, ref, what)


OPTIMIZERS = {
    "adamw": lambda m, s: m.adamw(s, weight_decay=0.1),
    "adamw_constant": lambda m, s: m.adamw(3e-3),
    "adafactor": lambda m, s: m.adafactor(s),
    "adafactor_decay": lambda m, s: m.adafactor(1e-2, weight_decay=0.05, clip_threshold=0.5),
    "lion": lambda m, s: m.lion(s, weight_decay=0.1),
    "sgd": lambda m, s: m.sgd(s),
    "sgd_momentum": lambda m, s: m.sgd(s, momentum=0.9),
    "clip": lambda m, s: m.clip_by_global_norm(1.0),
    "chain": lambda m, s: m.chain(m.clip_by_global_norm(0.5), m.adamw(s)),
    "scaled_chain": lambda m, s: m.scale_updates(
        m.chain(m.clip_by_global_norm(1.0), m.lion(s)), 0.5),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_optimizers_match_the_reference_over_five_steps(name):
    rng = np.random.default_rng(len(name))
    p0 = [rng.standard_normal(s).astype(np.float32) for s in SHAPES]
    ropt = OPTIMIZERS[name](RO, RO.cosine_warmup(3e-2, 2, 5))
    topt = OPTIMIZERS[name](TO, TO.cosine_warmup(3e-2, 2, 5))
    rparams = [jnp.asarray(p) for p in p0]
    tparams = [torch.tensor(p) for p in p0]
    rstate, tstate = ropt.init(rparams), topt.init(tparams)
    _close_tree(tstate, rstate, f"{name} init")
    for step in range(5):
        grads = [(rng.standard_normal(s) * 10 ** rng.uniform(-3, 1)).astype(np.float32)
                 for s in SHAPES]
        rupd, rstate = ropt.update([jnp.asarray(g) for g in grads], rstate, rparams,
                                   jnp.int32(step))
        tupd, tstate = topt.update([torch.tensor(g) for g in grads], tstate, tparams, step)
        rparams = RO.apply_updates(rparams, rupd)
        TO.apply_updates(tparams, tupd)
        _close_tree(tupd, list(rupd), f"{name} step {step} updates")
        _close_tree(tstate, rstate, f"{name} step {step} state")
        _close_tree(tparams, list(rparams), f"{name} step {step} params")
