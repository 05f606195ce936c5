"""Early stopping on validation accuracy; a copy of
``vargp_tpu/train/stopper.py`` (the reference's train_utils.py:69-98)."""


class EarlyStopper:
    """Patience-based stopper keeping the best-scoring payload.

    patience < 0 disables stopping (the toy runs); delta is the minimum
    improvement that resets the counter.
    """

    def __init__(self, patience: int = 10, delta: float = 1e-4):
        self.patience = patience
        self.delta = delta
        self._counter = 0
        self._best_info = None
        self._best_score = None

    def is_done(self) -> bool:
        if self.patience >= 0:
            return self._counter >= self.patience
        return False

    def info(self):
        return self._best_info

    def best_score(self):
        return self._best_score

    def __call__(self, score: float, info) -> None:
        """``info`` may be a callable (a lazy payload): it is called only
        when the score improves, so a caller can defer an expensive
        snapshot to the improving evaluations."""
        assert not self.is_done()
        if self._best_score is not None and score < self._best_score + self.delta:
            self._counter += 1
            return
        self._best_score = score
        self._best_info = info() if callable(info) else info
        self._counter = 0
