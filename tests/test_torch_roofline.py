"""The port's ``launch/roofline.py`` accounting against the reference's
at every full config (the MoE active share, the analytic FLOPs of a train,
prefill and decode step with the quadratic attention term, the encdec
family's as the reference counts it), and its refusal of an unknown
family."""
import types

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_config  # noqa: E402
from repro.launch import roofline as RR  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import roofline as TR  # noqa: E402

ARCHS = ["tinyllama_1b", "mamba2_370m", "minicpm3_4b", "qwen2_moe_a2_7b", "arctic_480b",
         "recurrentgemma_2b", "olmo_1b", "gemma_2b", "phi3_vision_4b", "whisper_medium"]


@pytest.mark.parametrize("arch", ARCHS)
def test_active_share_and_analytic_flops_match_the_reference(arch):
    jcfg, cfg = jax_config(arch), get_config(arch)
    shapes = jax.eval_shape(lambda k: jax_build(jcfg).init(k)[0], jax.random.PRNGKey(0))
    n_params = RR.count_params(shapes)
    assert TR.active_param_fraction(cfg) == RR.active_param_fraction(jcfg)
    if cfg.family == "moe":
        assert TR.active_param_fraction(cfg) < 0.5
    shape = types.SimpleNamespace(global_batch=8, seq_len=4096)
    for kind in ("train", "prefill", "decode"):
        assert TR.analytic_flops(cfg, n_params, shape, kind) == \
            RR.analytic_flops(jcfg, n_params, shape, kind), kind


def test_unported_family_raises():
    """encdec is counted now: the reference's figures at a cut whisper
    (its quadratic term over all n_layers, as the reference counts it); an
    unknown family raises."""
    jcfg = jax_config("whisper_medium").replace(n_enc_layers=2, n_dec_layers=3)
    cfg = get_config("whisper_medium").replace(n_enc_layers=2, n_dec_layers=3)
    shapes = jax.eval_shape(lambda k: jax_build(jcfg).init(k)[0], jax.random.PRNGKey(0))
    n_params = RR.count_params(shapes)
    assert TR.active_param_fraction(cfg) == RR.active_param_fraction(jcfg) == 1.0
    shape = types.SimpleNamespace(global_batch=4, seq_len=1500)
    for kind in ("train", "prefill", "decode"):
        assert TR.analytic_flops(cfg, n_params, shape, kind) == \
            RR.analytic_flops(jcfg, n_params, shape, kind), kind
    with pytest.raises(ValueError, match="unknown family"):
        TR.active_param_fraction(cfg.replace(family="retnet"))
