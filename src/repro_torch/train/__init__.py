"""The shared step loop (``train_loop``) and its checkpoint resume
(``restore_train_state``), the train state and the LM train step. The
sharded step (``shard_train_step``) waits for ROADMAP.md Queue A 14.9."""
from repro_torch.train.loop import restore_train_state, train_loop
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.trainer import make_serve_steps, make_train_step

__all__ = ["TrainState", "init_train_state", "make_train_step", "make_serve_steps",
           "restore_train_state", "train_loop"]
