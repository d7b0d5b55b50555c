"""ReduceLROnPlateau on the host, the JAX package's ``train/plateau.py`` as
its trainers use it: mode 'min', with ``torch.optim.lr_scheduler.
ReduceLROnPlateau``'s defaults as constants (threshold 1e-4 in 'rel' mode:
improvement means ``new < best * (1 - 1e-4)``; cooldown 0, min_lr 0).

The LR lives here, not in the optimizer: the train step sets it in Adam's
``param_groups`` each step, and ``state_dict`` round-trips through a
checkpoint's ``host_state.json``."""
from __future__ import annotations

THRESHOLD = 1e-4


class ReduceLROnPlateau:
    def __init__(self, lr: float, factor: float = 0.1, patience: int = 10):
        if factor >= 1.0:
            raise ValueError("Factor should be < 1.0")
        self.lr = float(lr)
        self.factor = factor
        self.patience = patience
        self.num_bad_epochs = 0
        self.best = float("inf")

    def step(self, metric: float) -> float:
        """Feed the epoch metric; returns the (possibly reduced) current LR."""
        if metric < self.best * (1.0 - THRESHOLD):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.num_bad_epochs > self.patience:
            new_lr = self.lr * self.factor
            print(f"ReduceLROnPlateau: reducing lr {self.lr:.2e} -> {new_lr:.2e}")
            self.lr = new_lr
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        return dict(self.__dict__)

    def load_state_dict(self, state: dict) -> None:
        self.__dict__.update(state)
