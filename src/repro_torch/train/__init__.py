"""The training path: the train step (loss -> grads -> optional int8
compression -> clip -> AdamW) and the loop around it (data -> step ->
heartbeat -> checkpoint -> resume)."""

from repro_torch.train.loop import LoopConfig, train_loop
from repro_torch.train.step import init_train_state, make_train_step, train_step

__all__ = [
    "LoopConfig", "train_loop", "init_train_state", "make_train_step",
    "train_step",
]
