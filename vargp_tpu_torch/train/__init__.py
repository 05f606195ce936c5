"""Training: the optimizers, the ELBO step and the on-device train block;
counterpart of ``vargp_tpu/train`` (``train_task`` and its evaluation,
metrics and stopper are not ported yet)."""
