"""The port's MLA attention (``models.layers.mla_apply``) against the JAX
package's on the same weights and inputs, on the reduced minicpm3 config:
no cache (training), a prefill into an empty cache, a chunked prefill at
pos > 0, three per-slot decode steps, and a per-slot step with one slot at
pos == max_len, whose write is dropped (the reference's scatter drops it).
The outputs and the cache's ``ckv``/``krope`` are compared after each call.

Tolerances, relative to each tensor's largest magnitude, as
``tests/test_torch_lm.py``: f32 1e-5; bf16 4e-2 (the frameworks round to
bf16 at other places)."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch_train_cases import one_thread  # noqa: E402,F401

from repro.configs import get_reduced_config as jax_config  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro_torch.configs import get_reduced_config  # noqa: E402
from repro_torch.models import layers as TL  # noqa: E402

REL = {"float32": 1e-5, "bfloat16": 4e-2}
B, MAX_LEN = 2, 24


def _close(got, ref, rel, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rel * max(float(np.abs(ref).max()), 1e-30), f"{what}: max err {err:.3e}"


class Pair:
    """The reference's and the port's MLA on the same weights and caches."""

    def __init__(self, dtype, seed=0):
        self.jcfg = jax_config("minicpm3_4b").replace(dtype=dtype)
        self.cfg = get_reduced_config("minicpm3_4b").replace(dtype=dtype)
        self.dtype = dtype
        jp, _ = RL.init_mla(jax.random.PRNGKey(seed), self.jcfg)
        self.jparams = jp
        self.params = {k: torch.tensor(np.asarray(v)) for k, v in jp.items()}
        self.fn = jax.jit(functools.partial(RL.mla_apply, cfg=self.jcfg))
        self.rng = np.random.default_rng(seed)
        jc, _ = RL.init_mla_cache(self.jcfg, B, MAX_LEN, 1, jnp.dtype(dtype))
        self.jcache = {"ckv": jc["ckv"][0], "krope": jc["krope"][0], "pos": jc["pos"]}
        tc = TL.init_mla_cache(self.cfg, B, MAX_LEN, 1, getattr(torch, dtype))
        self.cache = {"ckv": tc["ckv"][0], "krope": tc["krope"][0], "pos": tc["pos"]}

    def x(self, S):
        return self.rng.standard_normal((B, S, self.cfg.d_model)).astype(np.float32)

    def run(self, x, positions, cache=True):
        """Both sides on x (numpy f32, cast to the dtype) at ``positions``;
        returns (port out, reference out) and advances both caches."""
        jx = jnp.asarray(x).astype(jnp.dtype(self.dtype))
        tx = torch.tensor(x).to(getattr(torch, self.dtype))
        jpos, tpos = jnp.asarray(positions), torch.tensor(positions)
        jout, jc = self.fn(self.jparams, jx, positions=jpos, cache=self.jcache if cache else None)
        tout, tc = TL.mla_apply(self.params, tx, self.cfg, positions=tpos,
                                cache=self.cache if cache else None)
        if cache:
            self.jcache, self.cache = jc, tc
        else:
            assert jc is None and tc is None
        return tout, jout

    def check_cache(self, what):
        rel = REL[self.dtype]
        for key in ("ckv", "krope"):
            _close(self.cache[key], self.jcache[key], rel, f"{what}: cache {key}")
        assert np.array_equal(np.asarray(self.cache["pos"]), np.asarray(self.jcache["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_without_a_cache_matches_jax(dtype):
    pair = Pair(dtype)
    tout, jout = pair.run(pair.x(12), np.arange(12), cache=False)
    _close(tout, jout, REL[dtype], "out")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_prefill_chunked_prefill_and_per_slot_decode_match_jax(dtype):
    pair = Pair(dtype, seed=1)
    rel = REL[dtype]
    tout, jout = pair.run(pair.x(10), np.arange(10))
    _close(tout, jout, rel, "prefill")
    pair.check_cache("prefill")
    assert int(pair.cache["pos"]) == 10
    tout, jout = pair.run(pair.x(5), 10 + np.arange(5))
    _close(tout, jout, rel, "chunked prefill at pos 10")
    pair.check_cache("chunked prefill")
    # per-slot positions: slot 1 holds fewer tokens than slot 0
    pos = np.asarray([15, 9], np.int32)
    pair.jcache["pos"], pair.cache["pos"] = jnp.asarray(pos), torch.tensor(pos)
    for step in range(3):
        tout, jout = pair.run(pair.x(1), (pos + step)[:, None])
        _close(tout, jout, rel, f"per-slot decode {step}")
        pair.check_cache(f"per-slot decode {step}")
    assert pair.cache["pos"].tolist() == [18, 12]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_per_slot_write_past_the_cache_is_dropped(dtype):
    pair = Pair(dtype, seed=2)
    pair.run(pair.x(MAX_LEN), np.arange(MAX_LEN))
    before = pair.cache["ckv"].clone()
    pos = np.asarray([MAX_LEN, 5], np.int32)
    pair.jcache["pos"], pair.cache["pos"] = jnp.asarray(pos), torch.tensor(pos)
    tout, jout = pair.run(pair.x(1), pos[:, None])
    _close(tout, jout, REL[dtype], "decode with a slot at max_len")
    pair.check_cache("decode with a slot at max_len")
    assert torch.equal(pair.cache["ckv"][0], before[0])  # slot 0 wrote nothing
    assert not torch.equal(pair.cache["ckv"][1, 5], before[1, 5])


def test_mla_scalar_pos_past_the_cache_raises():
    """The reference's dynamic_update_slice clamps the start; the port
    refuses, as attention_apply does (ROADMAP Queue C 3)."""
    pair = Pair("float32")
    pair.run(pair.x(20), np.arange(20))
    with pytest.raises(ValueError, match="cannot take"):
        pair.run(pair.x(5), 20 + np.arange(5))
