"""Training: the optimizers, the ELBO step, the on-device train block and
the evaluation metrics; counterpart of ``vargp_tpu/train`` (``train_task``
and its evaluation loop and stopper are not ported yet)."""
