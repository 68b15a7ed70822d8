"""Readings for the limits of a cell's correctness numbers, on the card.

    python3 perfbench/control.py --workload <cell> --sound-seeds 1,2,... \
        --control-seeds 7,8,9 [--seconds 30]

Prints one JSON line per reading:

- ``sound``: the program's numbers on a seed, from the cell's own set-up
  and checked steps (a training cell needs no measured window; a serving
  cell runs ``--seconds`` of its load, as a run does);
- ``control``: the plain reference computed in TF32 (the precision below
  the configuration's float32 with TF32 off) put in the program's place;
- ``half_batch`` (training cells): the reference with half of each batch
  left out, the mean over the rest;
- ``index_altered`` (training cells): one sampled index moved;
- ``exchange_left_out`` (a learn loop on several chips, ``world`` in its
  mix): the reference on rank 0's rows alone, as rank 0 updates when the
  gradients' pmean is left out;
- ``action_altered`` (the serving cell): one served action moved by 1e-2.

The benchmark's own runs never run this.  A limit lies above the largest
sound reading and below the smallest of the others (PERF.md gives both).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import compare, harness, inputs, models  # noqa: E402


def training_readings(cell, seed, device):
    conf, traffic, model = cell.config, cell.traffic, models.entry(cell.config)
    if traffic["kind"] != "train":  # a learn loop, on one chip or on several
        def ref(**kw):
            return model.learn(conf, traffic, seed, device, kw.pop("idx", None), **kw)
    else:
        env_seed = inputs.subseed(seed, "env")

        def ref(**kw):
            return model.train(conf, seed, env_seed, device, kw.pop("idx", None),
                               traffic["check_units"], **kw)
    base = ref()
    moved = [i.clone() for i in base["indices"]]
    moved[0][0] = (moved[0][0] + conf["trainer"]["capacity"] // 2) % conf["trainer"]["capacity"]
    control = ref(precision="tf32")
    out = {}
    faults = [("half_batch", conf["trainer"]["batch_size"] // 2)]
    if traffic.get("world", 1) > 1:
        faults.append(("exchange_left_out", conf["trainer"]["batch_size"] // traffic["world"]))
    # The control is judged as the program is: the reference follows its
    # indices where its own draw bears them out.
    for name, got, judge in (
            ("control", control, ref(idx=control["indices"])),
            *((fault, ref(rows=rows), base) for fault, rows in faults),
            ("index_altered", ref(idx=moved), None)):
        if judge is None:  # the moved index is the program's: its own run judges it
            got, judge = base, got
        out[name] = dict(compare.training_checks(got, judge), **compare.wide_checks(got, judge))
    return out


def serving_readings(window, seed, conf, device):
    st = window.readings["streams"]
    obs, reset, served = st["obs"], st["reset"], st["action"]
    mask = np.arange(obs.shape[1])[None, :] < st["count"][:, None]
    model = models.entry(conf)
    params = inputs.make_weights(model.shapes(conf), seed, device)["actor"]
    want = model.actions(params, obs, reset, "float32", device)
    tf32 = model.actions(params, obs, reset, "tf32", device)
    moved = served.copy()
    lane, step = map(int, next(zip(*mask.nonzero())))
    moved[lane, step, 0] += 1e-2
    return {"control": compare.serving_checks(tf32, want, mask),
            "action_altered": compare.serving_checks(moved, want, mask)}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--sound-seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=30.0)
    args = p.parse_args()
    harness.pin_caches()
    cell = harness.find_cell(args.workload)
    device = torch.device("cuda", 0)
    serving = cell.traffic["kind"] == "serve"
    seeds = [("sound", int(s)) for s in args.sound_seeds.split(",") if s]
    seeds += [("control", int(s)) for s in args.control_seeds.split(",") if s]
    for what, seed in seeds:
        t0 = time.perf_counter()
        rec = {"workload": args.workload, "seed": seed}
        if what == "sound" or serving:
            run = harness.Run(cell=cell, seed=seed, seconds=args.seconds if serving else 0.0,
                              trace=False, device=device, started=t0)
            window = harness.run_driver(run)
            rec["sound"] = window.checks
            rec["sound_wide"] = window.readings.get("wide")
            if serving:
                rec["requests"] = window.attempted
            if serving and what == "control":
                rec.update(serving_readings(window, seed, cell.config, device))
        else:
            rec.update(training_readings(cell, seed, device))
        rec["seconds"] = time.perf_counter() - t0
        print(json.dumps(rec), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
