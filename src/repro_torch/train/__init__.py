"""The shared step loop of the fit layer (``train_loop``) and its
checkpoint resume (``restore_train_state``); the LM trainer waits for ROADMAP
Queue A 14."""
from repro_torch.train.loop import restore_train_state, train_loop

__all__ = ["restore_train_state", "train_loop"]
