"""Checkpoint and resume: the port's own on-disk format.

Port of ``r2d2dpg_tpu/utils/checkpoint.py``.  The JAX package writes orbax
checkpoints; the port writes ``torch.save`` files and keeps the manager's
semantics:

- A step is the directory ``<dir>/<step>/``.  It is written as
  ``<dir>/<step>.tmp-<pid>/`` and finalized by ``os.rename``, so a reader
  that admits only all-digit names (``latest_step``, the serving
  reloader) never sees a step half written.
- The saved tree is the whole ``TrainerState`` (full) or ``{"train":
  state.train}`` (light, with the ``LIGHT_CHECKPOINTS`` marker in the
  directory).  Each top-level key of the tree is its own file
  ``<step>/<key>.pt``: nested dicts and lists of CPU tensors and ints (a
  dataclass becomes a dict of its fields, parameter dicts keep the port's
  flax-path keys, the draws object its generator's state).  A restore of
  ``{"train": ...}`` opens ``train.pt`` and nothing else, so a reader of a
  full checkpoint never reads the replay arena.
- Every restore walks a template and raises one ``ValueError`` naming
  every leaf that the checkpoint lacks or holds at another shape or dtype
  (``check_restored_leaves``).  Files load with ``weights_only=True``.

A full checkpoint holds the arena, the window, the env state, the carries,
the counters and the state of the ``Draws`` generator, so a resume
continues the run exactly.  A light resume keeps only the learner and
re-runs warm-up and fill.

A trainer on a ``dp`` mesh (``--spmd D``, ``--learner-dp D``) saves its
GLOBAL state (``parallel/layout.py``): every rank calls ``save(...,
trainer=)``, each field is gathered to rank 0 and written there before
the next one is gathered, and only rank 0 writes.  ``resume_state`` reads
the same files on every rank into the global template, keeps the rank's
rows and holds the replicated leaves equal across ranks.  A ``--spmd D``
checkpoint carries D draw streams and resumes only at world size D.

Reading the JAX package's orbax checkpoints needs orbax, which imports
JAX: it is not done here (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch

from r2d2dpg_torch.obs import flight_event
from r2d2dpg_torch.parallel import distributed
from r2d2dpg_torch.training.draws import Draws

LIGHT_MARKER = "LIGHT_CHECKPOINTS"
_MISSING = object()
Path = Tuple[str, ...]


# ------------------------------------------------------------------- trees
def to_tree(obj: Any) -> Any:
    """A state as nested dicts/lists of CPU tensors and ints (what is saved)."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, (bool, int, float)):
        return obj
    if isinstance(obj, Draws):
        return {"generator_state": obj.generator.get_state()}
    if dataclasses.is_dataclass(obj):
        return {f.name: to_tree(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, dict):
        return {str(k): to_tree(v) for k, v in obj.items()}
    if isinstance(obj, (tuple, list)):
        return [to_tree(x) for x in obj]
    raise TypeError(f"cannot checkpoint a {type(obj).__name__}")


def _children(node: Any) -> Iterator[Tuple[str, Any]]:
    """(key, child) pairs of a template node; nothing for a leaf."""
    if dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            yield f.name, getattr(node, f.name)
    elif isinstance(node, dict):
        yield from ((str(k), v) for k, v in node.items())
    elif isinstance(node, (tuple, list)):
        yield from ((str(i), v) for i, v in enumerate(node))


def _is_leaf(node: Any) -> bool:
    return isinstance(node, (torch.Tensor, bool, int, float))


def _template_leaves(template: Any, path: Path = ()) -> Iterator[Tuple[Path, Any]]:
    if _is_leaf(template):
        yield path, template
    elif isinstance(template, Draws):
        yield path + ("generator_state",), template.generator.get_state()
    else:
        for key, child in _children(template):
            yield from _template_leaves(child, path + (key,))


def _get(tree: Any, path: Path) -> Any:
    for key in path:
        if isinstance(tree, dict) and key in tree:
            tree = tree[key]
        elif isinstance(tree, list) and key.isdigit() and int(key) < len(tree):
            tree = tree[int(key)]
        else:
            return _MISSING
    return tree


def _describe(x: Any) -> str:
    if isinstance(x, torch.Tensor):
        return f"{str(x.dtype).replace('torch.', '')}{list(x.shape)}"
    return type(x).__name__


def check_restored_leaves(
    restored: Any, template: Any, *, where: str, hint: str
) -> None:
    """Raise ONE ``ValueError`` naming every template leaf that ``restored``
    lacks, or holds at another shape, dtype or type."""
    missing, mismatched = [], []
    for path, want in _template_leaves(template):
        got = _get(restored, path)
        name = "/".join(path)
        if got is _MISSING:
            missing.append(name)
        elif isinstance(want, torch.Tensor):
            if not (
                isinstance(got, torch.Tensor)
                and got.shape == want.shape
                and got.dtype == want.dtype
            ):
                mismatched.append(
                    f"{name} (checkpoint {_describe(got)} vs expected {_describe(want)})"
                )
        elif type(got) is not type(want):
            mismatched.append(
                f"{name} (checkpoint {_describe(got)} vs expected {_describe(want)})"
            )
    if not (missing or mismatched):
        return

    def clip(items: List[str]) -> str:
        return ", ".join(items[:8]) + (" ..." if len(items) > 8 else "")

    raise ValueError(
        f"checkpoint at {where} does not match the restore template ({hint}): "
        + (f"{len(missing)} leaves missing: {clip(missing)}; " if missing else "")
        + (f"{len(mismatched)} leaves mismatched: {clip(mismatched)}"
           if mismatched else "")
    )


def _rebuild(template: Any, tree: Any, device) -> Any:
    """``template``'s structure with ``tree``'s values (already checked).

    Tensors land on ``device``, or on the template leaf's device when
    ``device`` is None.  A ``Draws`` template gets the saved generator state
    (the template's generator is reused, so pass a fresh one).
    """
    if isinstance(template, torch.Tensor):
        return tree.to(template.device if device is None else device)
    if _is_leaf(template):
        return tree
    if isinstance(template, Draws):
        template.generator.set_state(tree["generator_state"])
        return template
    if dataclasses.is_dataclass(template):
        return dataclasses.replace(template, **{
            k: _rebuild(v, tree[k], device) for k, v in _children(template)
        })
    if isinstance(template, dict):
        return {k: _rebuild(v, tree[str(k)], device) for k, v in template.items()}
    return type(template)(
        _rebuild(v, tree[i], device) for i, v in enumerate(template)
    )


# ------------------------------------------------------------------- disk
def all_steps(directory: str) -> List[int]:
    """Finalized steps under ``directory``, ascending (all-digit names only:
    a ``<step>.tmp-<pid>`` directory is a save still in flight, or one that
    died)."""
    try:
        entries = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(e) for e in entries if e.isdigit())


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def _write_step(directory: str, step: int, fields: Iterator[Tuple[str, Any]]) -> None:
    """Each ``(key, tree)`` of ``fields`` as the file ``<key>.pt`` of
    ``<directory>/<step>/``, one at a time, atomically."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = f"{final}.tmp-{os.getpid()}"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    for key, value in fields:
        torch.save(value, os.path.join(tmp, f"{key}.pt"))
    if os.path.exists(final):  # a same-step save replaces the old one
        shutil.rmtree(final)
    os.rename(tmp, final)


def restore_subtree(
    checkpoint_dir: str,
    template: Dict[str, Any],
    *,
    step: Optional[int] = None,
    device=None,
    hint: str = "wrong net or knobs for this checkpoint?",
) -> Tuple[Dict[str, Any], int]:
    """Restore ``template`` (a dict keyed like the checkpoint, e.g.
    ``{"train": {"actor_params": tmpl}}``) from the latest (or given) step.

    Returns ``(restored, step)``.  Only the files of ``template``'s
    top-level keys are read.  Tensor leaves land on ``device`` (default:
    each template leaf's device; a ``meta`` template needs a ``device``).
    """
    directory = os.path.abspath(checkpoint_dir)
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {checkpoint_dir}")
    step_dir = os.path.join(directory, str(step))
    loaded = {}
    for key in template:
        path = os.path.join(step_dir, f"{key}.pt")
        if os.path.exists(path):
            # To host memory first: only the template's leaves move on.
            loaded[key] = torch.load(path, map_location="cpu", weights_only=True)
    check_restored_leaves(
        loaded, template, where=f"{checkpoint_dir} (step {step})", hint=hint
    )
    return _rebuild(template, loaded, device), step


# ----------------------------------------------------------------- manager
class CheckpointManager:
    """Periodic save + latest-restore of ``TrainerState`` under ``directory``.

    ``save_every``: N > 0 saves every N phases (and the caller's final
    save), -1 only the final save (``maybe_save`` never fires, the truthy
    value keeps the caller's final save armed), 0 nothing.  ``light``
    saves only the learner subtree: megabytes instead of the arena's
    gigabytes, what ``eval`` and the serving reloader read; a light resume
    starts replay and the phase schedule afresh.
    """

    def __init__(
        self,
        directory: str,
        *,
        save_every: int = 500,
        max_to_keep: int = 3,
        light: bool = False,
    ):
        if max_to_keep < 1:
            raise ValueError("max_to_keep must be >= 1")
        self.directory = os.path.abspath(directory)
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self.light = light
        self._saved_step: Optional[int] = None  # this manager's last save

    # ------------------------------------------------------------------ save
    def maybe_save(self, phase: int, state: Any, trainer=None) -> bool:
        """Save if ``phase`` hits the cadence.  Returns True when saved."""
        if self.save_every <= 0 or phase % self.save_every != 0:
            return False
        self.save(phase, state, trainer)
        return True

    def save(self, step: int, state: Any, trainer=None) -> None:
        """Save at ``step``, replacing an existing same-step checkpoint (a
        light resume restarts its phase numbering at 0, so a resumed run
        revisits steps already on disk).  In light mode ``state`` only
        needs a ``train`` attribute.

        With ``trainer`` (a mesh trainer) the save is collective: every
        rank calls it, the fields are gathered to rank 0 one at a time,
        and rank 0 writes them; its layout check is agreed first."""
        primary = distributed.is_primary()
        refused = None
        if primary:
            try:
                self._check_layout(saving=True)
            except ValueError as e:
                refused = e
        if trainer is not None and not trainer._agree(refused is None):
            raise refused or ValueError(
                f"rank 0 refused the checkpoint layout of {self.directory}")
        if refused is not None:
            raise refused
        names = ["train"] if self.light else [f.name for f in dataclasses.fields(state)]

        def fields():
            for name in names:
                value = (getattr(state, name) if trainer is None
                         else trainer.global_field(state, name))
                if primary:
                    yield name, to_tree(value)

        if primary:
            _write_step(self.directory, step, fields())
            for old in self.all_steps()[: -self.max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
            flight_event(
                "checkpoint_save", step=int(step), directory=self.directory,
                light=self.light,
            )
        else:
            for _ in fields():
                pass
        self._saved_step = step

    def save_final(self, step: int, state: Any, trainer=None) -> None:
        """End-of-run save; a no-op when the cadence already saved ``step``
        (rank 0's reading of it, with ``trainer``)."""
        done = self._saved_step == step or (
            self._saved_step is None and self.latest_step == step)
        if trainer is not None:
            done = trainer._agree(done)
        if done:
            return
        self.save(step, state, trainer)

    def _check_layout(self, *, saving: bool) -> None:
        """Refuse light/full mode mismatches against what is on disk."""
        marker = os.path.join(self.directory, LIGHT_MARKER)
        if self.light:
            if self.all_steps() and not os.path.exists(marker):
                raise ValueError(
                    f"{self.directory} holds FULL checkpoints but this manager "
                    "is light=True: drop --checkpoint-light or point at a "
                    "fresh directory"
                )
            if saving and not os.path.exists(marker):
                os.makedirs(self.directory, exist_ok=True)
                with open(marker, "w") as f:
                    f.write("train-subtree-only checkpoints\n")
        elif os.path.exists(marker):
            raise ValueError(
                f"{self.directory} holds LIGHT checkpoints but this manager is "
                "light=False: pass --checkpoint-light to match (eval is "
                "unaffected: it restores the train subtree from either layout)"
            )

    # --------------------------------------------------------------- restore
    @property
    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def all_steps(self) -> List[int]:
        return all_steps(self.directory)

    def restore(self, template: Any, device=None) -> Any:
        """The latest checkpoint in ``template``'s structure and devices
        (or on ``device``).

        ``template`` is a concrete ``TrainerState`` (``trainer.init()``; its
        draws object takes the saved generator state).  In light mode only
        the learner subtree is stored and returned.
        """
        self._check_layout(saving=False)
        hint = "another config, knob or device than the saving run?"
        if self.light:
            out, _ = restore_subtree(
                self.directory, {"train": template.train}, hint=hint, device=device)
            return out["train"]
        fields = dict(_children(template))
        out, _ = restore_subtree(self.directory, fields, hint=hint, device=device)
        return dataclasses.replace(template, **out)

    def saved_draw_streams(self) -> int:
        """The draw streams of the latest full checkpoint: its world size
        for ``--spmd D`` (``parallel/layout.py::RankDraws``), else 1."""
        path = os.path.join(self.directory, str(self.latest_step), "draws.pt")
        if not os.path.exists(path):
            return 1  # the restore names the missing leaves
        draws = torch.load(path, map_location="cpu", weights_only=True)
        return int(draws.get("world_size", 1)) if isinstance(draws, dict) else 1


def resume_state(trainer, ckpt: CheckpointManager):
    """``trainer.init()`` overwritten by the latest checkpoint.

    A full checkpoint gives back the whole state (the resume continues the
    run exactly on the device it was saved from); a light one only the
    learner, with replay, window, envs and the phase schedule fresh.  A
    mesh trainer reads the global state and keeps its rows; a checkpoint
    with per-rank draw streams refuses another world size.
    """
    fresh = trainer.init()
    if ckpt.light:
        state = dataclasses.replace(fresh, train=ckpt.restore(fresh))
    else:
        saved, have = ckpt.saved_draw_streams(), trainer.draw_streams
        if saved != have:
            raise ValueError(
                f"{ckpt.directory} step {ckpt.latest_step} was saved at world "
                f"size {saved} with one draw stream per --spmd rank; this run "
                f"has world size {have}: resume it at world size {saved}, or "
                "from a light checkpoint")
        template = trainer._global_template(fresh)
        state = trainer.local_state(ckpt.restore(
            template, device=None if template is fresh else "cpu"))
    trainer._check_replicated(state)
    return state
