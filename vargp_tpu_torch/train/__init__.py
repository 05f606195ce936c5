"""Training: the optimizers, the ELBO step, the on-device train block,
the evaluation, the early stopper and ``train_task``; counterpart of
``vargp_tpu/train``."""
