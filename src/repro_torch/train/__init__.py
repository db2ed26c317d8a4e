"""The shared step loop (``train_loop``) and its checkpoint resume
(``restore_train_state``), the train state, the LM train step and its
sharded form over a ``DeviceMesh`` (``shard_train_step``)."""
from repro_torch.train.loop import restore_train_state, train_loop
from repro_torch.train.state import TrainState, init_train_state
from repro_torch.train.trainer import make_serve_steps, make_train_step, shard_train_step

__all__ = ["TrainState", "init_train_state", "make_train_step", "make_serve_steps",
           "shard_train_step", "restore_train_state", "train_loop"]
