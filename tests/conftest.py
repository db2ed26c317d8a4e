import os
import sys

# Tests run on the single real CPU device. The 512-device dry-run sets
# XLA_FLAGS itself inside repro/launch/dryrun.py (and must NOT leak here).
os.environ.setdefault("JAX_PLATFORMS", "cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's kernels); skipped without one"
    )


# ---------------------------------------------------------------------------
# Optional-dependency shim: the CI image may lack `hypothesis`, which the
# property tests import at module scope (collection would abort for the whole
# suite). When absent, install a minimal deterministic stand-in that runs each
# @given test over a fixed sample of the strategy space. With the real
# package installed this block is inert.
# ---------------------------------------------------------------------------
try:  # pragma: no cover - exercised only when hypothesis is installed
    import hypothesis  # noqa: F401
except ImportError:
    import types

    import numpy as _np

    class _Strategy:
        def __init__(self, sampler):
            self.sampler = sampler  # rng -> value

        def sample(self, rng):
            return self.sampler(rng)

    def _integers(min_value, max_value):
        return _Strategy(lambda rng: int(rng.integers(min_value, max_value + 1)))

    def _floats(min_value, max_value):
        return _Strategy(
            lambda rng: float(rng.uniform(min_value, max_value))
        )

    def _lists(elements, min_size=0, max_size=10):
        def sampler(rng):
            size = int(rng.integers(min_size, max_size + 1))
            return [elements.sample(rng) for _ in range(size)]

        return _Strategy(sampler)

    def _settings(max_examples=20, deadline=None, **_kw):
        def deco(fn):
            fn._stub_max_examples = max_examples
            return fn

        return deco

    def _given(*strategies):
        def deco(fn):
            def wrapper():
                rng = _np.random.default_rng(0)
                # @settings may sit above or below @given — check both targets
                n = getattr(
                    wrapper, "_stub_max_examples", None
                ) or getattr(fn, "_stub_max_examples", 20)
                for _ in range(n):
                    vals = [s.sample(rng) for s in strategies]
                    fn(*vals)

            # zero-arg signature: pytest must not treat the strategy params
            # as fixture requests
            wrapper.__name__ = fn.__name__
            wrapper.__doc__ = fn.__doc__
            wrapper.__module__ = fn.__module__
            return wrapper

        return deco

    stub = types.ModuleType("hypothesis")
    stub.given = _given
    stub.settings = _settings
    stub.strategies = types.ModuleType("hypothesis.strategies")
    stub.strategies.integers = _integers
    stub.strategies.floats = _floats
    stub.strategies.lists = _lists
    sys.modules["hypothesis"] = stub
    sys.modules["hypothesis.strategies"] = stub.strategies
