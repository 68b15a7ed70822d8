"""Port parity: ``r2d2dpg_torch/topology.py`` against ``r2d2dpg_tpu/topology.py``.

- Every row of the port's ``REFUSALS`` fires from its ``argv`` (through the
  real train CLI at one process; through ``validate`` at the row's
  ``processes``) with the JAX row's message, exactly.  The exceptions are
  pinned on their own: ``pipeline-x-phase-subsystems`` (narrowed to
  ``--profile-phases``) and ``pipeline-x-nan-inject`` (no port row).  The
  port has no row of its own: ``--pipeline 1`` runs in a world of D
  processes, and ``describe()`` gives JAX's stamp there.
- ``resolve`` and ``describe()`` equal JAX's, letter for letter, on a grid
  of flag sets; the value checks give JAX's messages.
- The world-size rule: ``--spmd D`` / ``--learner-dp D`` need D processes.
- The train CLI prints ``topology: <describe()>`` and writes it to
  ``<logdir>/topology.txt``; ``train.py`` has no refusal branch of its own.

Exact equality throughout: these are strings.
"""

import pytest

from r2d2dpg_tpu import topology as jtopology
from r2d2dpg_tpu import train as jtrain
from r2d2dpg_torch import topology, train

J_ROWS = {r.key: r for r in jtopology.REFUSALS}
NARROWED = {"pipeline-x-phase-subsystems"}
NOT_IN_PORT = {"pipeline-x-nan-inject"}


def _port_args(*argv):
    return train.parse_args(["--config", "pendulum_tiny", *argv])


def _jax_args(*argv):
    return jtrain.parse_args(["--config", "pendulum_tiny", *argv])


@pytest.mark.parametrize("rule", topology.REFUSALS, ids=[r.key for r in topology.REFUSALS])
def test_refusal_table_pins_every_row(rule):
    """Each row's argv refuses with its reason, which is the JAX row's."""
    if rule.processes == 1:
        with pytest.raises(SystemExit) as e:
            train.main(["--config", "pendulum_tiny", *rule.argv, "--device", "cpu"])
    else:
        with pytest.raises(SystemExit) as e:
            topology.validate(_port_args(*rule.argv), process_count=rule.processes)
        # One process short of that world, the row stays quiet.
        assert not rule.when(_port_args(*rule.argv), 1)
    assert str(e.value) == rule.reason
    assert rule.match in rule.reason
    if rule.key not in NARROWED:
        assert rule.reason == J_ROWS[rule.key].reason
        assert rule.match == J_ROWS[rule.key].match


def test_table_differs_from_jax_only_where_named():
    port = {r.key for r in topology.REFUSALS}
    assert set(J_ROWS) - port == NOT_IN_PORT
    assert port - set(J_ROWS) == set()  # no row of the port's own
    # Same order as the JAX table for the shared rows.
    shared = [k for k in J_ROWS if k in port]
    assert [r.key for r in topology.REFUSALS if r.key in J_ROWS] == shared


def test_narrowed_and_dropped_rows():
    """``--pipeline 1`` refuses only ``--profile-phases`` (JAX also refuses
    ``--resume``/``--eval-every``), and runs ``--nan-inject-phase``."""
    row = next(r for r in topology.REFUSALS if r.key == "pipeline-x-phase-subsystems")
    assert row.reason == (
        "--pipeline 1 does not support --profile-phases yet (the executor "
        "owns the phase loop; docs/TOPOLOGY.md)")
    for argv in (("--pipeline", "1", "--eval-every", "5"),
                 ("--pipeline", "1", "--nan-inject-phase", "1"),
                 ("--pipeline", "1", "--resume", "--checkpoint-dir", "d")):
        assert topology.validate(_port_args(*argv)).schedule == "pipelined_overlap"
        with pytest.raises(SystemExit):
            jtopology.validate(_jax_args(*argv), process_count=1)


def test_multiprocess_row_names_each_flag_left_out():
    """No row refuses a world of 2 processes on its own: ``--spmd 2
    --pipeline 1`` (walker_r2d2, with the lifecycle flags) resolves to
    JAX's stamp at ``process_count=2``, the fleet, checkpoints, resume and
    evals run there, and the rows that still meet ``--pipeline`` at D = 2
    are JAX's, with JAX's messages."""
    assert not any(r.processes > 1 and r.key not in J_ROWS for r in topology.REFUSALS)
    for config in ("walker_r2d2", "pendulum_tiny"):
        for argv in ((), ("--minutes", "1"),
                     ("--checkpoint-dir", "d", "--trace-sample", "0.5")):
            argv = ("--config", config, "--spmd", "2", "--pipeline", "1", *argv)
            got = topology.validate(train.parse_args(list(argv)), process_count=2)
            want = jtopology.validate(jtrain.parse_args(list(argv)), process_count=2)
            assert got.describe() == want.describe()
            assert got.schedule == "pipelined_overlap" and got.learn == "spmd_mesh"
    # The port's own pipeline pairings (JAX refuses them at any world size).
    for argv in (("--nan-inject-phase", "1"), ("--checkpoint-dir", "d", "--resume"),
                 ("--eval-every", "5")):
        got = topology.validate(_port_args("--spmd", "2", "--pipeline", "1", *argv),
                                process_count=2)
        assert got.schedule == "pipelined_overlap"
    for argv in (("--learner-dp", "2", "--pipeline", "1"),
                 ("--actors", "2", "--learner-dp", "2", "--pipeline", "1"),
                 ("--obs-fleet", "1", "--pipeline", "1", "--spmd", "2")):
        with pytest.raises(SystemExit) as got:
            topology.validate(_port_args(*argv), process_count=2)
        with pytest.raises(SystemExit) as want:
            jtopology.validate(_jax_args(*argv), process_count=2)
        assert str(got.value) == str(want.value)
    # (--actors pairs with --learner-dp: --spmd has a JAX row of its own.)
    for mesh, argv in ((("--learner-dp", "2"), ("--actors", "2")),
                       (("--learner-dp", "2"), ("--actors", "2", "--replay-shards", "2")),
                       (("--spmd", "2"), ("--checkpoint-dir", "d")),
                       (("--learner-dp", "2"), ("--resume", "--checkpoint-dir", "d")),
                       (("--spmd", "2"), ("--eval-every", "5"))):
        got = topology.validate(_port_args(*mesh, *argv), process_count=2)
        want = jtopology.validate(_jax_args(*mesh, *argv), process_count=1)
        assert got.describe() == want.describe()


GRID = [
    (),
    ("--pipeline", "1"),
    ("--actors", "2"),
    ("--actors", "2", "--replay-shards", "2"),
    ("--actors", "2", "--replay-shards", "2", "--shard-procs", "2", "--shard-direct", "1"),
    ("--actors", "3", "--replay-shards", "1"),
    ("--replay-shards", "1"),
    ("--learner-dp", "1"),
    ("--learner-dp", "4"),
    ("--spmd", "1"),
    ("--spmd", "8"),
    ("--actors", "2", "--learner-dp", "1"),
    ("--actors", "2", "--learner-dp", "2"),
    ("--actors", "2", "--replay-shards", "2", "--learner-dp", "2"),
]


@pytest.mark.parametrize("argv", [
    ("--overlap-learner", "1"), ("--overlap-learner", "0"), ("--spmd", "2"),
    ("--spmd", "2", "--overlap-learner", "1"), ("--pipeline", "1"),
], ids=lambda a: "_".join(a))
def test_walker_describe_equals_jax(argv):
    """The DM-Control config's stamps: the host-pool trainer's flags."""
    port = topology.resolve(train.parse_args(["--config", "walker_r2d2", *argv]))
    ref = jtopology.resolve(jtrain.parse_args(["--config", "walker_r2d2", *argv]))
    assert port.describe() == ref.describe()
    assert train.parse_args(["--config", "walker_r2d2", *argv]).overlap_learner == (
        jtrain.parse_args(["--config", "walker_r2d2", *argv]).overlap_learner)


def test_overlap_learner_rows_fire_with_jax_messages():
    for argv in (("--actors", "2", "--overlap-learner", "1"),
                 ("--learner-dp", "2", "--overlap-learner", "1")):
        with pytest.raises(SystemExit) as port:
            topology.validate(_port_args(*argv), process_count=2)
        with pytest.raises(SystemExit) as ref:
            jtopology.validate(_jax_args(*argv), process_count=1)
        assert str(port.value) == str(ref.value)
        assert "--overlap-learner 1" in str(port.value)
    assert topology.validate(_port_args("--overlap-learner", "1")).describe()


@pytest.mark.parametrize("argv", GRID, ids=lambda a: "_".join(a) or "plain")
def test_resolve_and_describe_equal_jax(argv):
    port = topology.resolve(_port_args(*argv))
    ref = jtopology.resolve(_jax_args(*argv))
    assert port.describe() == ref.describe()
    stages = ("collect", "ingest", "sample", "learn", "schedule")
    assert [getattr(port, s) for s in stages] == [getattr(ref, s) for s in stages]
    assert port.composed == ref.composed


VALUE_CHECKS = [
    ("--learner-dp", "-1"),
    ("--replay-shards", "-2"),
    ("--shard-procs", "-1"),
    ("--actors", "2", "--replay-shards", "3", "--shard-procs", "2"),
    ("--shard-pullers", "-1"),
    ("--trace-sample", "1.5"),
    ("--actors", "2", "--fleet-heartbeat", "0"),
    ("--actors", "2", "--chaos-spec", "bogus@x"),
    ("--actors", "2", "--autoscale", "1", "--autoscale-cooldown", "0"),
    ("--actors", "2", "--autoscale", "1", "--autoscale-every", "0"),
    ("--actors", "2", "--autoscale", "1", "--autoscale-fire", "0"),
    ("--actors", "2", "--autoscale", "1", "--autoscale-min", "0"),
    ("--actors", "2", "--autoscale", "1", "--autoscale-min", "3", "--autoscale-max", "2"),
    ("--actors", "3", "--autoscale", "1", "--autoscale-max", "2"),
]


@pytest.mark.parametrize("argv", VALUE_CHECKS, ids=lambda a: "_".join(a))
def test_value_checks_equal_jax(argv):
    with pytest.raises(SystemExit) as port:
        topology.validate(_port_args(*argv))
    with pytest.raises(SystemExit) as ref:
        jtopology.validate(_jax_args(*argv), process_count=1)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("flag", ["--spmd", "--learner-dp"])
def test_mesh_needs_one_process_per_device(flag):
    with pytest.raises(SystemExit, match=f"torchrun --nproc-per-node 2 .* {flag} 2"):
        topology.validate(_port_args(flag, "2"), process_count=1)
    # A torchrun world of 2 without a mesh flag would run two plain trainers.
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        topology.validate(_port_args(), process_count=2)
    assert topology.validate(_port_args(flag, "2"), process_count=2).describe()


def test_train_has_no_refusal_branch_of_its_own():
    assert not hasattr(train, "_refuse")
    assert not hasattr(train, "_fleet_only_knobs")


def test_cli_prints_and_writes_the_topology_stamp(tmp_path, capsys):
    logdir = tmp_path / "log"
    train.main(["--config", "pendulum_tiny", "--phases", "1", "--log-every", "0",
                "--device", "cpu", "--logdir", str(logdir)])
    want = jtopology.resolve(_jax_args()).describe()
    assert f"topology: {want}" in capsys.readouterr().out.splitlines()
    assert (logdir / "topology.txt").read_text() == want + "\n"


def test_chip_smoke_stamps_equal_jax():
    """The stamps ``chip_smoke.py``'s mesh legs hold the card runs to (it
    imports no JAX) are JAX's ``describe()`` for the same flags."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke_stamps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert mod.TOPOLOGY_STAMPS
    for flags, want in mod.TOPOLOGY_STAMPS.items():
        assert jtopology.resolve(_jax_args(*flags)).describe() == want
        assert topology.resolve(_port_args(*flags)).describe() == want
