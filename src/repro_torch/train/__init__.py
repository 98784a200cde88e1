"""Training: the LM train step (microbatching, metrics) and the paper
pipelines' SGD step (the counterpart of ``repro.train``)."""

from repro_torch.train.step import (TrainState, init_state, loss_and_grads,
                                    make_sgd_step, make_train_step)

__all__ = ["TrainState", "init_state", "loss_and_grads", "make_sgd_step",
           "make_train_step"]
