"""Training: the optimizers, the gradient step and the on-device train
block every model uses, the evaluation, the early stopper and
``train_task``; counterpart of
``vargp_tpu/train``.  The JAX package's ``make_update_fn`` (one dispatch
per minibatch, ``scan_epoch=False``) is not ported."""

from vargp_tpu_torch.train.loop import TrainHyperparams, make_predict_fn, train_task
from vargp_tpu_torch.train.metrics import compute_acc_ent, compute_accuracy, compute_bwt
from vargp_tpu_torch.train.stopper import EarlyStopper

__all__ = [
    "EarlyStopper",
    "compute_accuracy",
    "compute_acc_ent",
    "compute_bwt",
    "TrainHyperparams",
    "train_task",
    "make_predict_fn",
]
