"""Early stopping on the host, the JAX package's ``train/early_stopping.py``
as its trainers use it (mode 'min', verbose): a score improves when it
falls below the best by more than ``min_delta``; a patience counter, the
``early_stop`` flag, is-best for checkpoint gating and a ``state_dict`` for
resume."""
from __future__ import annotations


class EarlyStopping:
    def __init__(self, patience: int = 20, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.counter = 0
        self.best_score = None
        self.early_stop = False
        self.best_epoch = 0

    def __call__(self, score: float, epoch: int) -> bool:
        """Returns True when `score` is a new best (save-checkpoint signal)."""
        if self.best_score is None:
            print(f"EarlyStopping: initialized best score = {score:.6f}")
        elif score < self.best_score - self.min_delta:
            print(f"EarlyStopping: improved {self.best_score:.6f} -> {score:.6f}")
            self.counter = 0
        else:
            self.counter += 1
            print(f"EarlyStopping: no improvement (current: {score:.6f}, "
                  f"best: {self.best_score:.6f}), counter: "
                  f"{self.counter}/{self.patience}")
            if self.counter >= self.patience:
                self.early_stop = True
                print(f"EarlyStopping triggered: no improvement for "
                      f"{self.patience} epochs (best epoch {self.best_epoch}, "
                      f"best score {self.best_score:.6f})")
            return False
        self.best_score = score
        self.best_epoch = epoch
        return True

    # --- state for checkpoint/resume ---
    def state_dict(self) -> dict:
        return {"counter": self.counter, "best_score": self.best_score,
                "early_stop": self.early_stop, "best_epoch": self.best_epoch}

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
