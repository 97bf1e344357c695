"""Last + best-k checkpoints on the task's monitor (counterpart of
`lookoncetohear_tpu/train/checkpoint.py`), as npz files in place of
orbax directories, under the same names: `run_dir/last.ckpt`,
`run_dir/best/epoch=E-step=S.ckpt` (the top k), `run_dir/best.ckpt`
(a symlink to the top entry) and `run_dir/ckpt_meta.json`. Each file
is a `train/npz_ckpt.py` checkpoint: params and full state."""

from __future__ import annotations

import json
import os

from lookoncetohear_tpu_torch.train.npz_ckpt import save_npz


class CheckpointManager:
    """last + top-k checkpoints keyed on a monitored metric."""

    def __init__(self, run_dir: str, monitor: str, mode: str = "max",
                 top_k: int = 5) -> None:
        self.run_dir = run_dir
        self.monitor = monitor
        self.mode = mode
        self.top_k = top_k
        self.best_dir = os.path.join(run_dir, "best")
        os.makedirs(self.best_dir, exist_ok=True)
        self.meta_path = os.path.join(run_dir, "ckpt_meta.json")
        self.meta = {"best": []}  # list of {name, value, epoch, step}
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                self.meta = json.load(f)

    @property
    def last_path(self) -> str:
        return os.path.join(self.run_dir, "last.ckpt")

    def _write_meta(self) -> None:
        with open(self.meta_path, "w") as f:
            json.dump(self.meta, f, indent=1)

    def save_last(self, model, full_state, epoch: int, step: int) -> None:
        save_npz(self.last_path, model, full_state)
        self.meta["last"] = {"epoch": epoch, "step": step}
        self._write_meta()

    def save_best(self, model, full_state, value: float, epoch: int,
                  step: int) -> None:
        """Keep only if it lands in the top-k on the monitor."""
        entries = self.meta["best"]
        sign = -1.0 if self.mode == "max" else 1.0
        name = f"epoch={epoch}-step={step}.ckpt"
        entries.append({"name": name, "value": float(value),
                        "epoch": epoch, "step": step})
        entries.sort(key=lambda e: sign * e["value"])
        keep = entries[: self.top_k]
        self.meta["best"] = keep
        if not any(e["name"] == name for e in keep):
            self._write_meta()
            return
        save_npz(os.path.join(self.best_dir, name), model, full_state)
        self._write_meta()
        for e in entries[self.top_k:]:
            p = os.path.join(self.best_dir, e["name"])
            if os.path.exists(p):
                os.remove(p)
        best_link = os.path.join(self.run_dir, "best.ckpt")
        if os.path.lexists(best_link):
            os.unlink(best_link)
        os.symlink(os.path.join("best", keep[0]["name"]), best_link)

    def best_checkpoint(self) -> str | None:
        if not self.meta["best"]:
            return None
        return os.path.join(self.best_dir, self.meta["best"][0]["name"])

    def has_last(self) -> bool:
        return os.path.exists(self.last_path)
