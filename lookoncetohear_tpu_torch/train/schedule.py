"""LR schedulers (a copy of `lookoncetohear_tpu/train/schedule.py`).

`ReduceLROnPlateau` reproduces torch.optim.lr_scheduler.
ReduceLROnPlateau as the committed configs use it (mode=min,
patience=5, factor=0.5, min_lr=1e-6), as a plain host-side object:
`step(metric)` returns the new learning rate, which the Trainer writes
into the optimizer's `param_groups`. Its state dict is the JAX
package's, so a checkpoint carries it the same way.
"""

from __future__ import annotations

import math


class ReduceLROnPlateau:
    def __init__(self, lr: float, mode: str = "min", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_lr: float = 0.0, eps: float = 1e-8) -> None:
        if mode not in ("min", "max"):
            raise ValueError(f"mode must be 'min' or 'max', not {mode!r}")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError("threshold_mode must be 'rel' or 'abs', not "
                             f"{threshold_mode!r}")
        self.lr = float(lr)
        self.mode = mode
        self.factor = factor
        self.patience = patience
        self.threshold = threshold
        self.threshold_mode = threshold_mode
        self.cooldown = cooldown
        self.min_lr = min_lr
        self.eps = eps
        self.best: float | None = None
        self.num_bad_epochs = 0
        self.cooldown_counter = 0

    def _is_better(self, metric: float) -> bool:
        if self.best is None:
            return True
        if self.mode == "min":
            bar = self.best * (1.0 - self.threshold) \
                if self.threshold_mode == "rel" else self.best \
                - self.threshold
            return metric < bar
        bar = self.best * (1.0 + self.threshold) \
            if self.threshold_mode == "rel" else self.best + self.threshold
        return metric > bar

    def step(self, metric: float) -> float:
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        # NaN stands in for "no best yet" (checkpoint formats dislike
        # None leaves).
        best = float("nan") if self.best is None else float(self.best)
        return {"lr": float(self.lr), "best": best,
                "num_bad_epochs": int(self.num_bad_epochs),
                "cooldown_counter": int(self.cooldown_counter)}

    def load_state_dict(self, state: dict) -> None:
        self.lr = float(state["lr"])
        best = float(state["best"])
        self.best = None if math.isnan(best) else best
        self.num_bad_epochs = int(state["num_bad_epochs"])
        self.cooldown_counter = int(state["cooldown_counter"])
