"""Checkpoint hot-reload: poll a training run's directory, swap actor params live.

Port of ``r2d2dpg_tpu/serving/reload.py`` over the port's checkpoints
(``utils/checkpoint.py``).

- ``poll()`` runs on the serving worker between batches (never during a
  policy step), at most every ``poll_every_s``.  Finding a new step is one
  directory listing (all-digit names: finalized steps only); a restore
  reads ``{"train": {"actor_params": ...}}`` alone, from the step's
  ``train`` file, straight onto the reloader's device.
- Every restore is checked leaf for leaf against the serving actor's
  template (``actor_params_template``), so a checkpoint of another net
  (width, torso, twin-critic layout does not matter: only the actor) is
  REJECTED and the service keeps serving the previous params.
- A failed poll (a validation reject, an unreadable file) is kept in
  ``last_error`` for the health snapshot and retried on the next cadence.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from r2d2dpg_torch.utils.checkpoint import latest_step, restore_subtree


def actor_params_template(actor) -> Dict[str, torch.Tensor]:
    """Shapes and dtypes of ``actor``'s params on the meta device (no
    storage): what a reloader checks checkpoints against."""
    return {k: torch.empty_like(v, device="meta") for k, v in actor.named_parameters()}


class CheckpointHotReloader:
    """Polls ``checkpoint_dir`` for new steps and restores actor params onto ``device``."""

    def __init__(
        self,
        checkpoint_dir: str,
        template: Dict[str, torch.Tensor],
        *,
        device: Any = "cpu",
        poll_every_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.template = template
        self.device = torch.device(device)
        self.poll_every_s = poll_every_s
        self._clock = clock
        self._last_poll_t: Optional[float] = None
        self.current_step: Optional[int] = None
        self.last_load_t: Optional[float] = None
        self.last_error: Optional[str] = None
        self.reloads = 0

    # ------------------------------------------------------------------ load
    def load_latest(self) -> Dict[str, torch.Tensor]:
        """Blocking initial load (service start); raises on missing/mismatch."""
        params, step = self._restore(step=None)
        self._mark_loaded(step)
        return params

    def poll(self) -> Optional[Dict[str, torch.Tensor]]:
        """Between-batches check; new validated params or None.

        None means: not yet due, no NEW step, or a failed or invalid restore
        (kept in ``last_error`` and retried on the next cadence).
        """
        now = self._clock()
        if (
            self._last_poll_t is not None
            and now - self._last_poll_t < self.poll_every_s
        ):
            return None
        self._last_poll_t = now
        try:
            step = latest_step(self.checkpoint_dir)
            if step is None or step == self.current_step:
                return None
            params, step = self._restore(step=step)
        except Exception as e:  # noqa: BLE001 - serving must outlive bad checkpoints
            self.last_error = f"{type(e).__name__}: {e}"
            return None
        self._mark_loaded(step)
        return params

    # -------------------------------------------------------------- internal
    def _restore(self, step: Optional[int]):
        out, step = restore_subtree(
            self.checkpoint_dir,
            {"train": {"actor_params": self.template}},
            step=step,
            device=self.device,
            hint="serving actor tree: checkpoint from another net config "
            "(width / torso)?",
        )
        return out["train"]["actor_params"], step

    def _mark_loaded(self, step: int) -> None:
        self.current_step = step
        self.last_load_t = self._clock()
        self.last_error = None
        self.reloads += 1

    # ----------------------------------------------------------------- stats
    def staleness_s(self) -> float:
        """Seconds since the served params were loaded (inf before any load)."""
        if self.last_load_t is None:
            return float("inf")
        return self._clock() - self.last_load_t
