"""The port's sharded train step against its unsharded step for the seven
reduced configs that ``test_torch_shard_train_step.py`` does not take:
minicpm3 (MLA), arctic (MoE with a dense residual), olmo-1b
(non-parametric layer norm), gemma-2b (MQA, tied embeddings),
phi-3-vision (the patch prefix), whisper-medium (encdec) and
recurrentgemma-2b (the hybrid's RG-LRU and local attention), all in one
gloo world on the (2, 2) ("data", "model") mesh, two steps of the same
optimizer (its learning rate is 0 at step 0, so the moments carry the
first step's check and the params the second's). Tolerances as there."""
import pytest

torch = pytest.importorskip("torch")

from test_torch_shard_train_step import check_case, run_meshes  # noqa: E402
from torch_shard_ranks import unsharded_steps  # noqa: E402
from torch_threads import one_thread  # noqa: E402,F401

ZOO = ("minicpm3_4b", "arctic_480b", "olmo_1b", "gemma_2b", "phi3_vision_4b",
       "whisper_medium", "recurrentgemma_2b")
STEPS = 2


@pytest.fixture(scope="module")
def world():
    return run_meshes({(2, 2): [(a, STEPS, "warmup", 1) for a in ZOO]})[2, 2]


@pytest.mark.parametrize("arch", ZOO)
def test_sharded_step_matches_the_unsharded_step(world, arch):
    ranks = [res[arch, 1] for res in world]
    check_case(ranks, unsharded_steps(arch, STEPS, "warmup", 1), "warmup", STEPS, arch)
