"""Model entries: what the harness needs that depends on a configuration's
architecture, found by name.

A configuration file names its entry in ``nets.core`` (a missing key means
``lstm``); the entry is the module ``perfbench/models/<core>.py``.  It gives:

- ``shapes(conf)``: ``{"actor": {key: shape}, "critic": {...}}``, the nets'
  weights, keyed by the program's module paths;
- ``carries(conf)``: ``{"actor": [(draw, shape), ...], "critic": [...]}``, the
  carry leaves the arena stores for each net, each with its per-row shape and
  the draw that fills it (``inputs.CARRY_DRAWS``); ``[]`` for none;
- ``seq_len(conf)``: the length of a stored sequence;
- ``NETS``: the reference's one-step ``actor_step`` and ``critic_step``, which
  ``reference/learner.py`` unrolls;
- ``learn(conf, traffic, seed, device, program_idx, precision="float32",
  rows=None)``: the reference learner run that the learn loops are judged by;
- ``train(...)`` and ``actions(...)``: the reference train and serve runs,
  where the entry has them;
- ``learn_unit(conf)``, and ``train_unit(conf)`` where it has a train run:
  analytic FLOPs of a learner step and of a train phase.

A configuration of a new architecture is added with its file, its entry and
the entry's reference nets, and no edit to a file the harness has.
"""

from __future__ import annotations

import importlib
from types import ModuleType
from typing import Dict

DEFAULT = "lstm"


def entry(conf: Dict) -> ModuleType:
    """The model entry that ``conf`` names."""
    return importlib.import_module(f"perfbench.models.{conf['nets'].get('core', DEFAULT)}")
