"""``python -m r2d2dpg_torch <cmd> ...``: subcommand dispatch.

``train`` (the default, so ``python -m r2d2dpg_torch --config ...`` runs
the train CLI), ``eval`` and ``serve``.  ``train`` and ``serve`` take
``--obs-port`` to serve the process's telemetry registry.
"""

import importlib
import sys


def main() -> None:
    cmds = {"train": "r2d2dpg_torch.train", "eval": "r2d2dpg_torch.eval",
            "serve": "r2d2dpg_torch.serve"}
    argv = sys.argv[1:]
    if argv and argv[0] in cmds:
        name, argv = cmds[argv[0]], argv[1:]
    else:
        name = cmds["train"]
    importlib.import_module(name).main(argv)


if __name__ == "__main__":
    main()
