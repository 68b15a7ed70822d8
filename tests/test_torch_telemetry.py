"""Port parity: the rest of telemetry against JAX.

Each test feeds the JAX package and the port the same inputs and compares
what comes out:

- the registry's ``prometheus_text`` / ``render_prometheus``, ``scalars()``
  and ``merge_remote`` (byte-equal text, equal dicts), including malformed
  and remote entries, a raising gauge and a broken instrument;
  ``RemoteMirror`` under a patched clock;
- every ``HealthEngine`` rule firing, clearing and warming up, with
  ``time.monotonic`` patched in both modules: ``evaluate()`` equal apart
  from ``t_wall``, the same ``health_verdict`` flight events and gauges;
- the exporter's endpoints (``/metrics``, ``/metrics.json``, ``/snapshot``,
  ``/health``, ``/healthz``, a 404, a raising gauge and a broken
  instrument): equal statuses and bodies apart from ``t_wall``;
- ``obs.flight merge`` with and without ``--trace-out`` on the same run
  directory: byte-equal output (the fused document's ``fusedBy`` names
  its producer's module), and JAX's refusals with the same messages;
- ``parse_profile_window`` over a table of specs (results and error texts),
  the MFU arithmetic under a patched clock, a CPU profile window and
  ``profile_window_spans``;
- ``MetricLogger(registry=)``: the same CSV columns and rows as JAX's;
- the learn FLOPs of one pendulum_tiny learner step against an analytic
  count (exact), with XLA's ``cost_analysis`` of the JAX step recorded;
- ``Trainer.run`` with the FLOP counter on its first train phase bitwise
  equal to one without it.

Every comparison is exact unless it says otherwise.
"""

import csv
import json
import math
import os
import types
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from r2d2dpg_tpu import obs as jobs
from r2d2dpg_tpu.obs import device as j_device
from r2d2dpg_tpu.obs import flight as j_flight
from r2d2dpg_tpu.obs import health as j_health
from r2d2dpg_tpu.obs import registry as j_registry
from r2d2dpg_tpu.utils.metrics import MetricLogger as JMetricLogger
from r2d2dpg_torch import obs as tobs
from r2d2dpg_torch.obs import device as t_device
from r2d2dpg_torch.obs import flight as t_flight
from r2d2dpg_torch.obs import health as t_health
from r2d2dpg_torch.obs import registry as t_registry
from r2d2dpg_torch.utils.metrics import MetricLogger

PKGS = {"jax": jobs, "port": tobs}


class Clock:
    """A monotonic clock the test advances by hand."""

    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


def _patch_clock(monkeypatch, clock, *mods):
    fake = types.SimpleNamespace(monotonic=clock, time=lambda: 1.5e9 + clock.t)
    for mod in mods:
        monkeypatch.setattr(mod, "time", fake)


def _nan_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        x, y = a[k], b[k]
        assert (math.isnan(x) and math.isnan(y)) or x == y, (k, x, y)


# ------------------------------------------------------------------ registry
def _populate(pkg):
    """The same instrument calls on a fresh registry of ``pkg``."""
    reg = pkg.Registry()
    reg.counter("t_total", "help text").inc(3)
    reg.gauge("t_gauge", "a\nmulti-line help").set(1.5)
    reg.gauge("t_int_gauge").set(7.0)
    reg.gauge("t_inf_gauge").set(float("-inf"))
    h = reg.histogram("t_lat_seconds", "latency", labelnames=("pool",), window=64)
    for v in (0.5, 0.25, 2.0, 1.0):
        h.labels(pool="native").observe(v)
    h.labels(pool='py"thon\\').observe(3.0)
    c = reg.counter("t_lbl_total", labelnames=("a", "b"))
    c.labels(a="x", b="y\nz").inc(2)
    c.labels(b="1", a="2").inc(5)

    def boom():
        raise RuntimeError("dead callback")

    reg.gauge("t_dead_gauge").set_fn(boom)
    broken = reg.gauge("t_broken_gauge")
    broken.set(1.0)
    broken._cells_snapshot = lambda: (_ for _ in ()).throw(
        RuntimeError("snapshot exploded"))
    return reg


def test_registry_text_scalars_and_snapshot_equal_jax():
    j, t = _populate(jobs), _populate(tobs)
    assert t.prometheus_text() == j.prometheus_text()
    assert "t_dead_gauge NaN" in t.prometheus_text()
    assert "# t_broken_gauge omitted: RuntimeError" in t.prometheus_text()
    _nan_equal(t.scalars(), j.scalars())
    assert json.dumps(t.snapshot(), default=str) == json.dumps(
        j.snapshot(), default=str)


MALFORMED = {
    "ok_total": {"kind": "counter", "help": "fine",
                 "samples": [{"labels": {}, "value": 2.0}]},
    "bad entry name": {"kind": "counter", "samples": []},
    "bad\nname_total": {"kind": "counter", "samples": [{"labels": {}, "value": 1.0}]},
    "half_formed": {"kind": "histogram", "samples": [{"labels": {}}]},
    "errored": {"kind": "gauge", "error": "RuntimeError: x\ny", "samples": []},
    "r2d2dpg_ok_gauge": {"kind": "gauge", "samples": [
        {"labels": {"host": "h1\nup 1"}, "value": 2.0},
        {"labels": {"bad\nkey": "v"}, "value": 3.0},
        {"labels": {}, "value": "not a number"},
        {"labels": {"w": "1"}, "error": "remote\nboom"},
    ]},
    "untyped_thing": {"samples": [{"labels": {}, "value": 0.1}]},
}


def test_render_prometheus_isolation_equal_jax():
    text = tobs.render_prometheus(MALFORMED)
    assert text == jobs.render_prometheus(MALFORMED)
    assert "up 1" not in text.splitlines()
    assert "# bad name_total omitted:" in text
    assert "# half_formed sample omitted: KeyError" in text


def _remote_sources(pkg):
    remote = pkg.Registry()
    remote.counter("r2d2dpg_actor_phases_total").inc(7)
    remote.gauge("r2d2dpg_x_gauge", labelnames=("actor",)).labels(actor="lying").set(1.0)
    remote.histogram("r2d2dpg_envpool_step_seconds").observe(0.1)
    skewed = {
        "r2d2dpg_envpool_step_seconds": {"kind": "histogram", "samples": [
            {"labels": {}, "count": 1, "total": 0.1, "p50": 0.1},
            {"labels": {}, "value": 3.0}]},
        "r2d2dpg_x_gauge": {"kind": "gauge", "help": "", "error": "RuntimeError: boom",
                            "samples": []},
        "r2d2dpg_y_gauge": {"kind": "gauge", "error": "dead", "samples": []},
        "not_a_dict": 3,
        "bad_samples": {"kind": "gauge", "samples": "nope"},
    }
    return [("actor:0", {"actor": "0", "host": "h1"}, remote.snapshot()),
            ("actor:1", {"actor": "1"}, skewed),
            ("actor:2", {"actor": "2"}, "not a snapshot")]


def test_merge_remote_equal_jax():
    out = {}
    for name, pkg in PKGS.items():
        base = pkg.Registry()
        base.counter("r2d2dpg_fleet_frames_total", labelnames=("actor",)).labels(
            actor="learner-side").inc(1)
        base.histogram("r2d2dpg_envpool_step_seconds").observe(0.5)
        base.gauge("r2d2dpg_x_gauge").set(1.0)
        merged = pkg.merge_remote(base.snapshot(), _remote_sources(pkg))
        out[name] = (json.dumps(merged, default=str), pkg.render_prometheus(merged))
    assert out["port"] == out["jax"]
    text = out["port"][1]
    assert 'r2d2dpg_actor_phases_total{actor="0",host="h1"} 7' in text
    assert 'r2d2dpg_x_gauge{actor="0",host="h1"} 1' in text
    assert text.count("# TYPE r2d2dpg_envpool_step_seconds") == 1


def test_remote_mirror_equal_jax(monkeypatch):
    clock = Clock()
    _patch_clock(monkeypatch, clock, j_registry, t_registry)
    seen = {}
    for name, pkg in PKGS.items():
        clock.t = 1000.0
        m = pkg.RemoteMirror()
        reg = pkg.Registry()
        reg.counter("r2d2dpg_actor_phases_total").inc(3)
        rows = []
        m.update("actor:0", {"actor": 0}, reg.snapshot())
        clock.t += 2.5
        m.update("actor:1", {"actor": "1"}, {})
        clock.t += 1.0
        m.update("actor:0", {"actor": "0"}, reg.snapshot())  # same slot
        clock.t += 4.0
        rows.append((m.sources(), m.staleness_s("actor:0"), m.staleness_s("actor:1"),
                     m.staleness_s("actor:9")))
        with pytest.raises(TypeError) as e:
            m.update("actor:2", {}, "not a snapshot")
        rows.append(str(e.value))
        m.drop("actor:0")
        m.drop("missing")
        rows.append(m.sources())
        m.clear()
        rows.append(m.sources())
        seen[name] = rows
    assert seen["port"] == seen["jax"]
    assert seen["port"][0][1:] == (4.0, 5.0, None)
    assert tobs.get_remote_mirror() is tobs.get_remote_mirror()


# -------------------------------------------------------------------- health
def _health_script(pkg, clock):
    """Drive every rule through warm-up, firing and clearing; returns the
    evaluations without ``t_wall``, the gauges after each, and the
    engines' verdict transitions as flight events."""
    reg = pkg.Registry()
    cfg = pkg.HealthConfig(expected_shard_procs=2)
    engine = pkg.HealthEngine(cfg, registry=reg, mirror=pkg.RemoteMirror())
    quiet = pkg.HealthEngine(pkg.HealthConfig(telem_expected=False), registry=reg)
    rec = pkg.get_flight_recorder()
    seq0 = rec.recorded_total if hasattr(rec, "recorded_total") else None
    n0 = len(rec.events())
    out = []

    def ev(label, step=1.0, eng=None):
        clock.t += step
        res = (eng or engine).evaluate()
        res.pop("t_wall")
        status = reg.get("r2d2dpg_health_status").value
        firing = {k[0]: c.value for k, c in
                  reg.get("r2d2dpg_health_rule_firing")._cells_snapshot()}
        out.append((label, res, status, reg.get("r2d2dpg_health_findings").value,
                    firing, reg.get("r2d2dpg_health_transitions_total").value))

    ev("empty")
    # learner_starving: an empty histogram is absence; a p99 over fires.
    wait = reg.histogram("r2d2dpg_sampler_wait_seconds")
    ev("starving_empty")
    wait.observe(2.0)
    ev("starving")
    wait.reset()
    ev("starving_cleared")
    # telem_stale: fires when expected, disarmed on the quiet engine.
    stale = reg.gauge("r2d2dpg_fleet_telem_staleness_seconds", labelnames=("actor",))
    stale.labels(actor="0").set(11.0)
    reg.gauge("r2d2dpg_shard_telem_staleness_seconds",
              labelnames=("shard",)).labels(shard="1").set(99.0)
    ev("telem_stale")
    ev("telem_stale_quiet_engine", eng=quiet)
    stale.labels(actor="0").set(1.0)
    reg.gauge("r2d2dpg_shard_telem_staleness_seconds",
              labelnames=("shard",)).labels(shard="1").set(0.5)
    ev("telem_cleared")
    # shard_skew: warm-up under the mean floor, then an empty shard.
    occ = reg.gauge("r2d2dpg_replay_shard_occupancy", labelnames=("shard",))
    occ.labels(shard="0").set(0.0)
    occ.labels(shard="1").set(10.0)
    ev("skew_warmup")
    occ.labels(shard="1").set(500.0)
    ev("skew")
    occ.labels(shard="0").set(250.0)
    ev("skew_cleared")
    # eviction_churn: a windowed rate with the sub-window guard.
    evict = reg.counter("r2d2dpg_replay_shard_evictions_total",
                        labelnames=("shard",)).labels(shard="0")
    ev("churn_baseline")
    evict.inc(64)
    ev("churn_sub_window", step=0.02)
    ev("churn_window", step=6.0)
    evict.inc(10_000)
    ev("churn_fires", step=6.0)
    ev("churn_rejudged", step=0.5)
    ev("churn_cleared", step=6.0)
    # actors_down / shards_down: the target off the scrape, alive below it.
    reg.gauge("r2d2dpg_fleet_actors_expected").set(2.0)
    alive = reg.gauge("r2d2dpg_fleet_actors_alive")
    shards = reg.gauge("r2d2dpg_shard_alive")
    alive.set(2.0)
    shards.set(2.0)
    ev("procs_ok")
    alive.set(1.0)
    ev("actors_down")
    shards.set(0.0)
    ev("shards_down_critical")
    shards.set(1.0)
    ev("shards_down_degraded")
    alive.set(2.0)
    shards.set(2.0)
    ev("procs_cleared")
    # recompile_churn: absent, then a first sighting already nonzero.
    rc = reg.counter("r2d2dpg_device_steady_recompiles_total")
    ev("recompile_zero")
    ev("recompile_window", step=6.0)
    rc.inc(2)
    ev("recompile_fires", step=6.0)
    ev("recompile_rejudged", step=1.0)
    ev("recompile_cleared", step=6.0)
    # hbm_pressure: no limit is exempt; in use over 0.92 of it fires.
    in_use = reg.gauge("r2d2dpg_device_hbm_bytes_in_use", labelnames=("device",))
    in_use.labels(device="0").set(99.0)
    ev("hbm_no_limit")
    reg.gauge("r2d2dpg_device_hbm_bytes_limit",
              labelnames=("device",)).labels(device="0").set(100.0)
    ev("hbm_pressure")
    in_use.labels(device="0").set(50.0)
    ev("hbm_cleared")
    # stale_experience: a sample floor, then a p99 over the max lag.
    lag = reg.histogram("r2d2dpg_quality_policy_lag")
    for _ in range(50):
        lag.observe(500.0)
    ev("lag_warmup")
    for _ in range(100):
        lag.observe(500.0)
    ev("stale_experience")
    lag.reset()
    ev("lag_cleared")
    # priority_collapse: 0 never armed; under the floor fires.
    ess = reg.gauge("r2d2dpg_quality_ess_frac")
    ev("ess_unarmed")
    ess.set(0.01)
    ev("priority_collapse")
    ess.set(0.5)
    ev("ess_cleared")
    # untrained_churn: an eviction floor, then the fraction over.
    unt = reg.gauge("r2d2dpg_quality_evicted_unsampled_total", labelnames=("shard",))
    frac = reg.gauge("r2d2dpg_quality_evicted_unsampled_frac", labelnames=("shard",))
    unt.labels(shard="0").set(100.0)
    frac.labels(shard="0").set(0.9)
    ev("untrained_warmup")
    unt.labels(shard="0").set(1000.0)
    ev("untrained_churn")
    frac.labels(shard="0").set(0.1)
    ev("untrained_cleared")
    # actor_skew: one actor, then a low mean, then a starved lane.
    trained = reg.gauge("r2d2dpg_quality_trained_seqs_total", labelnames=("actor",))
    trained.labels(actor="0").set(1000.0)
    ev("skew_one_actor")
    trained.labels(actor="1").set(10.0)
    trained.labels(actor="0").set(100.0)
    ev("actor_skew_warmup")
    trained.labels(actor="0").set(5000.0)
    ev("actor_skew")
    trained.labels(actor="1").set(4000.0)
    ev("actor_skew_cleared")
    # serve_queue_saturated: exempt until the worker has served.
    depth = reg.gauge("r2d2dpg_serve_queue_depth", labelnames=("worker",))
    reg.gauge("r2d2dpg_serve_queue_limit", labelnames=("worker",)).labels(
        worker="0").set(10.0)
    served = reg.gauge("r2d2dpg_serve_requests_total", labelnames=("worker",))
    depth.labels(worker="0").set(9.5)
    ev("serve_warmup")
    served.labels(worker="0").set(3.0)
    ev("serve_saturated")
    depth.labels(worker="0").set(1.0)
    ev("serve_cleared")
    # serve_shed_churn: per-worker windowed rate.
    sheds = reg.counter("r2d2dpg_serve_sheds_total", labelnames=("worker", "code"))
    sheds.labels(worker="0", code="shed_queue_full").inc(1)
    ev("shed_baseline")
    sheds.labels(worker="0", code="shed_queue_full").inc(100)
    sheds.labels(worker="0", code="shed_sessions_full").inc(100)
    ev("shed_sub_window", step=0.5)
    ev("shed_fires", step=6.0)
    ev("shed_cleared", step=6.0)
    # engine_error: a raising rule degrades the verdict, never raises.
    engine._rules = engine._rules + (
        lambda snap, findings: (_ for _ in ()).throw(RuntimeError("rule")),)
    ev("engine_error")
    events = [
        {k: e.get(k) for k in ("kind", "verdict", "previous", "rules")}
        for e in rec.events()[n0:] if e["kind"] == "health_verdict"
    ]
    del seq0
    return out, events


def test_health_rules_equal_jax(monkeypatch):
    clock = Clock()
    _patch_clock(monkeypatch, clock, j_health, t_health)
    assert t_health.RULES == j_health.RULES and len(t_health.RULES) == 15
    assert (
        [f.name for f in __import__("dataclasses").fields(tobs.HealthConfig)]
        == [f.name for f in __import__("dataclasses").fields(jobs.HealthConfig)])
    clock.t = 1000.0
    jout, jevents = _health_script(jobs, clock)
    clock.t = 1000.0
    tout, tevents = _health_script(tobs, clock)
    assert len(tout) == len(jout)
    for (label, *t_rest), (_, *j_rest) in zip(tout, jout):
        assert t_rest == j_rest, label
    assert tevents == jevents
    fired = {f["rule"] for _, res, *_ in tout for f in res["findings"]}
    assert fired == set(t_health.RULES)
    verdicts = {res["verdict"] for _, res, *_ in tout}
    assert verdicts == {"ok", "degraded", "critical"}


# ------------------------------------------------------------------ exporter
def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.headers["Content-Type"], r.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def _scrape_all(pkg, exporter_cls):
    reg = _populate(pkg)
    reg.histogram("r2d2dpg_sampler_wait_seconds").observe(30.0)
    mirror = pkg.RemoteMirror()
    remote = pkg.Registry()
    remote.counter("r2d2dpg_actor_phases_total").inc(5)
    mirror.update("actor:1", {"actor": "1"}, remote.snapshot())
    ex = exporter_cls(reg, port=0, host="127.0.0.1", mirror=mirror)
    out = []
    try:
        base = f"http://127.0.0.1:{ex.port}"
        for path in ("/metrics", "/metrics.json", "/snapshot", "/healthz",
                     "/nope", "/health", "/health?x=1", "/metrics"):
            status, ctype, body = _get(base + path)
            if path.startswith("/health") and path != "/healthz":
                body = json.loads(body)
                body.pop("t_wall")
            out.append((path, status, ctype, body))
        armed = pkg.HealthEngine(pkg.HealthConfig(learner_wait_p99_s=60.0),
                                 registry=reg, mirror=None)
        assert ex.arm_health(armed) is armed and ex.health is armed
        status, ctype, body = _get(base + "/health")
        body = json.loads(body)
        body.pop("t_wall")
        out.append(("/health armed", status, ctype, body))
    finally:
        ex.stop()
    return out


def test_exporter_endpoints_equal_jax():
    from r2d2dpg_tpu.obs.exporter import MetricsExporter as JExporter

    jout = _scrape_all(jobs, JExporter)
    tout = _scrape_all(tobs, tobs.MetricsExporter)
    assert tout == jout
    by_path = {p: (s, b) for p, s, _, b in tout}
    assert by_path["/nope"][0] == 404
    assert by_path["/health"][1]["verdict"] == "degraded"
    assert by_path["/health armed"][1]["verdict"] == "ok"
    text = by_path["/metrics"][1].decode()
    assert 'r2d2dpg_actor_phases_total{actor="1"} 5' in text
    assert "t_dead_gauge NaN" in text


def test_start_exporter_is_a_process_singleton():
    first = tobs.start_exporter(0, host="127.0.0.1")
    try:
        assert tobs.start_exporter(0) is first
        assert tobs.current_exporter() is first
        assert first.mirror is tobs.get_remote_mirror()
        body = json.loads(_get(f"http://127.0.0.1:{first.port}/health")[2])
        assert body["verdict"] in ("ok", "degraded", "critical")
        assert first.health is not None  # the lazy default stuck
    finally:
        tobs.stop_exporter()
    assert tobs.current_exporter() is None


# -------------------------------------------------------------- flight merge
def _run_dir(d):
    d.mkdir()
    (d / "flight.jsonl").write_text(
        json.dumps({"kind": "a", "t_wall": 2.0, "pid": 1}) + "\n"
        + json.dumps({"kind": "profile_start", "t_wall": 2.5, "pid": 1, "phase": 4,
                      "logdir": "x/profile_window"}) + "\n"
        + json.dumps({"kind": "profile_stop", "t_wall": 3.5, "pid": 1, "phase": 7,
                      "start_phase": 4, "seconds": 1.0}) + "\n"
        + json.dumps({"kind": "c", "t_wall": 4.0, "pid": 1}) + "\n")
    (d / "flight_actor0.jsonl").write_text(
        "garbage-line\n\n"
        + json.dumps({"kind": "b", "t_wall": 3.0, "actor": 0}) + "\n"
        + json.dumps([1, 2]) + "\n"
        + json.dumps({"kind": "z", "t_wall": 1.0, "actor": 0}) + "\n")
    (d / "flight_shard0.jsonl").write_text(
        json.dumps({"kind": "profile_start", "t_wall": 5.0, "pid": 9, "phase": 1}) + "\n")
    spans = [{"hop": "learn", "trace_id": 7, "t_wall": 2.2, "dur_s": 0.1, "pid": 1},
             {"hop": "sample_req", "trace_id": 7, "t_wall": 2.0, "dur_s": 0.05,
              "pid": 1, "draws": 8}]
    (d / "trace.json").write_text(json.dumps(t_flight.chrome_trace(spans)))
    (d / "trace_shard0.jsonl").write_text(
        json.dumps({"hop": "shard_draw", "trace_id": 7, "t_wall": 2.1, "dur_s": 0.01,
                    "pid": 9, "shard_proc": 0}) + "\n"
        + "torn{\n" + json.dumps({"no_hop": 1}) + "\n")


def _merge(main, argv, capsys):
    try:
        main(argv)
        code = None
    except SystemExit as e:
        code = str(e.code)
    cap = capsys.readouterr()
    return code, cap.out, cap.err


def test_flight_merge_equal_jax(tmp_path, capsys):
    d = tmp_path / "run"
    _run_dir(d)
    out = {}
    for name, mod in (("jax", j_flight), ("port", t_flight)):
        o = tmp_path / f"merged_{name}.jsonl"
        fused = tmp_path / f"fused_{name}.json"
        plain = _merge(mod.main, ["merge", str(d), "-o", str(o)], capsys)
        to_stdout = _merge(mod.main, ["merge", str(d)], capsys)
        with_trace = _merge(mod.main, ["merge", str(d), "-o", str(o), "--trace-out",
                                       str(fused)], capsys)
        doc = json.loads(fused.read_text())
        fused_text = fused.read_text().replace(doc["fusedBy"], "FUSED_BY")
        trace_only = _merge(mod.main, ["merge", str(d / "trace_shard0.jsonl"),
                                       "--trace-out", str(fused)], capsys)
        out[name] = dict(
            plain=(plain[0], plain[1], plain[2].replace(str(o), "OUT")),
            stdout=to_stdout,
            with_trace=(with_trace[0], with_trace[2].replace(str(o), "OUT").replace(
                str(fused), "FUSED")),
            trace_only=(trace_only[0], trace_only[2].replace(str(fused), "FUSED")),
            merged=o.read_bytes(),
            fused=fused_text,
            fused_shard_only=fused.read_text().replace(doc["fusedBy"], "FUSED_BY"),
            fused_by=doc["fusedBy"])
    assert out["port"].pop("fused_by") == "python -m r2d2dpg_torch.obs.flight merge"
    assert out["jax"].pop("fused_by") == "python -m r2d2dpg_tpu.obs.flight merge"
    assert out["port"] == out["jax"]
    lines = [json.loads(x) for x in out["port"]["merged"].decode().splitlines()]
    assert [e["kind"] for e in lines] == [
        "z", "a", "profile_start", "b", "profile_stop", "c", "profile_start"]
    fused = json.loads(out["port"]["fused"])
    windows = [e for e in fused["traceEvents"] if e["name"] == "profile_window"]
    assert [w["args"]["phase"] for w in windows] == [4, 1]  # one unterminated


def test_flight_merge_refusals_equal_jax(tmp_path, capsys):
    d = tmp_path / "run"
    _run_dir(d)
    empty = tmp_path / "empty"
    empty.mkdir()
    real = d / "trace.json"
    cases = [
        ["merge", str(d / "trace_shard0.jsonl")],
        ["merge", str(empty)],
        ["merge", str(d), "--trace-out", str(real)],
        ["merge", str(d / "flight_actor0.jsonl"), "--trace-out",
         str(tmp_path / "t.json")],
    ]
    for argv in cases:
        got = _merge(t_flight.main, argv, capsys)
        want = _merge(j_flight.main, argv, capsys)
        assert got[0] is not None and got[0].startswith("flight merge:"), got
        assert got == want, argv
    # The refused overwrite left the real span dump as it was.
    assert json.loads(real.read_text())["traceEvents"]


def test_flight_recorder_recorded_total_clear_and_jsonl_spans(tmp_path):
    fr = tobs.FlightRecorder(capacity=2)
    for i in range(3):
        fr.record("e", i=i)
    assert fr.recorded_total == 3 and len(fr.events()) == 2
    fr.clear()
    assert fr.events() == [] and fr.recorded_total == 3
    path = str(tmp_path / "trace_shard0.jsonl")
    fr.install(str(tmp_path / "flight_shard0.jsonl"), trace_path=path,
               trace_format="jsonl")
    fr.record_span("shard_draw", 3, 10.0, 0.5, shard_proc=0)
    assert fr.dump_trace() == path
    spans, skipped = t_flight.load_spans([path])
    j_spans, j_skipped = j_flight.load_spans([path])
    assert (spans, skipped) == (j_spans, j_skipped)
    assert spans[0]["hop"] == "shard_draw" and spans[0]["file"] == "trace_shard0.jsonl"
    with pytest.raises(ValueError, match="unknown trace_format"):
        fr.install(str(tmp_path / "f.jsonl"), trace_format="xml")


# ------------------------------------------------------------- device plane
SPECS = ["3:2", "1:1", " 4:3", "3", "a:b", "0:2", "3:0", "1:2:3", "", "-1:2", "2.5:1"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_profile_window_equal_jax(spec):
    def run(fn):
        try:
            return ("ok", fn(spec))
        except ValueError as e:
            return ("error", str(e))

    assert run(t_device.parse_profile_window) == run(j_device.parse_profile_window)
    assert t_device.METRIC_NAMES == tuple(
        n for n in j_device.METRIC_NAMES
        if n not in ("r2d2dpg_device_compile_total", "r2d2dpg_device_compile_seconds",
                     "r2d2dpg_device_steady_recompiles_total"))


def _mfu_script(mod, clock):
    reg = (jobs if mod is j_device else tobs).Registry()
    mon = mod.DeviceMonitor(registry=reg)
    rows = []

    def read():
        rows.append(tuple(reg.get(n).value for n in (
            "r2d2dpg_device_mfu", "r2d2dpg_device_learn_flops_total",
            "r2d2dpg_device_peak_flops")))

    mon.begin_run()
    mon.configure(peak_flops=1000.0)
    mon.set_learn_cost(100.0)
    mon.publish()  # opens the window
    read()
    for _ in range(10):
        mon.note_learn()
    clock.t += 0.5
    mon.publish()
    read()  # 1000 FLOPs over 0.5 s against 1000 FLOP/s: MFU 2
    mon.set_learn_cost(lambda: 7.0)  # lazy: evaluated at the next publish
    mon.note_learn()
    clock.t += 1.0
    mon.publish()
    read()
    mon.note_learn()
    mon.note_learn(flops=50.0)  # an explicit per-dispatch cost wins
    mon.set_learn_cost(lambda: 1 / 0)  # a raising cost keeps the old one
    clock.t += 2.0
    mon.publish()
    read()
    mon.note_learn()
    mon.publish()  # no time passed: the gauge holds
    read()
    mon.configure(0.0)  # unknown peak: MFU 0, never a made-up denominator
    mon.note_learn()
    clock.t += 1.0
    mon.publish()
    read()
    mon.begin_run()  # a new run reopens the window
    mon.note_learn()
    clock.t += 1.0
    mon.publish()
    read()
    return rows


def test_mfu_arithmetic_equal_jax(monkeypatch):
    clock = Clock()
    _patch_clock(monkeypatch, clock, j_device, t_device)
    clock.t = 50.0
    want = _mfu_script(j_device, clock)
    clock.t = 50.0
    got = _mfu_script(t_device, clock)
    assert got == want
    assert got[1] == (2.0, 1000.0, 1000.0)
    # A lazy cost takes over at the next publish; until then the previous
    # per-dispatch cost counts.
    assert got[2][1] == 1100.0


def test_cpu_profile_window_and_span_pairing(tmp_path):
    reg = tobs.Registry()
    mon = tobs.DeviceMonitor(registry=reg)
    rec = tobs.get_flight_recorder()
    n0 = rec.recorded_total
    logdir = tmp_path / "profile_window"
    assert mon.arm_profile("2:2", str(logdir)) == (2, 2)
    mon.begin_run()
    x = torch.ones(16, 16)
    for phase in range(1, 6):
        mon.on_phase(phase)
        x = torch.tanh(x @ x)
    mon.end_run()
    new = [e for e in rec.events() if e["seq"] >= n0 and e["kind"].startswith("profile_")]
    assert [e["kind"] for e in new] == ["profile_start", "profile_stop"]
    assert new[0]["phase"] == 2 and new[1]["phase"] == 4
    assert new[1]["start_phase"] == 2 and new[1]["seconds"] >= 0.0
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].startswith("profile_p2-3_pid")
    doc = json.loads((logdir / files[0]).read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    spans = t_flight.profile_window_spans(new)
    assert spans == j_flight.profile_window_spans(new)
    assert len(spans) == 1 and spans[0]["phase"] == 2
    assert spans[0]["dur_s"] == pytest.approx(new[1]["t_wall"] - new[0]["t_wall"])
    # A window still open at end_run closes with the JAX reason.
    mon2 = tobs.DeviceMonitor(registry=tobs.Registry())
    mon2.arm_profile("1:10", str(tmp_path / "pw2"))
    mon2.begin_run()
    mon2.on_phase(1)
    mon2.end_run()
    stop = [e for e in rec.events() if e["kind"] == "profile_stop"][-1]
    assert stop["reason"] == "end_run" and stop["phase"] is None
    assert len(os.listdir(tmp_path / "pw2")) == 1
    # One window per run: a re-armed phase does not restart it.
    mon2.on_phase(1)
    assert mon2._profile_active is None


def test_metric_logger_registry_columns_equal_jax(tmp_path):
    rows = {}
    for name, pkg in PKGS.items():
        reg = pkg.Registry()
        reg.gauge("bridge_gauge").set(5.0)
        reg.counter("episode_return_mean").inc(99)  # collides with a real key
        reg.histogram("lat_seconds", labelnames=("pool",)).labels(pool="a").observe(0.5)
        d = str(tmp_path / name)
        if name == "jax":
            log = JMetricLogger(d, stdout=False, tensorboard=False, registry=reg)
        else:
            log = MetricLogger(d, registry=reg)
        log.log(1, {"episode_return_mean": 1.5, "env_steps": 10.0})
        reg.gauge("late_gauge").set(2.0)  # a new column mid-run
        log.log(2, {"episode_return_mean": 2.5, "env_steps": 20.0})
        log.close()
        with open(os.path.join(d, "metrics.csv"), newline="") as f:
            r = list(csv.DictReader(f))
        rows[name] = [{k: v for k, v in row.items() if k != "wall_seconds"} for row in r]
    assert rows["port"] == rows["jax"]
    assert rows["port"][0]["bridge_gauge"] == "5.0"
    assert rows["port"][0]["episode_return_mean"] == "1.5"  # explicit key won
    assert rows["port"][1]["late_gauge"] == "2.0"
    assert "lat_seconds{pool=a}_p99" in rows["port"][0]


def test_learner_step_flops_equal_analytic_count(capsys):
    """The FLOPs of one pendulum_tiny learner step (B 8, obs 3, act 1,
    hidden 32, burn-in 2, unroll U 4, n-step 2), counted by
    ``FlopCounterMode``, equal the analytic count of its matrix products
    (within 1 %; they are exactly equal).

    A product ``[M, K] @ [K, N]`` costs 2·M·K·N.  Per step of B rows the
    actor costs ``a = 2B(3H + 4H·H + 4H·H + H·A)`` (torso, LSTM input and
    recurrent kernels, head) and the critic ``c = 2B(3H + (H+A)·H + 4H·H +
    4H·H + H)`` (torso, mix, LSTM, head).  The step runs: the fused burn-in
    over 2 steps with online and target params stacked (``2·burnin·(a+c)``);
    the targets through the target nets over U + n steps (``(U+n)(a+c)``);
    the critic unroll (``U·c``) and its backward: every weight gradient
    (``U·c``) and the input gradients of mix, the LSTM input kernel and
    the head at every step (``U(Mc + Wic + Hdc)``), of the recurrent kernel
    from the second step on (``(U-1)·Whc``; the burned-in carry has no
    gradient), never of the torso (its input is the observation); the
    actor-through-critic unroll (``U(a+c)``) and its backward: the actor's
    weight gradients (``U·a``), the actor's input gradients (``U(Wia +
    Hda) + (U-1)·Wha``) and the frozen critic's input gradients
    (``U(Mc + Wic + Hdc) + (U-1)·Whc``), no critic weight gradient.  Adam,
    Polyak, the norms and the priorities are elementwise.

    XLA's ``cost_analysis`` of the JAX step at the same config also counts
    elementwise work; it is printed beside the port's count, not held.
    """
    from test_torch_agent import _setup

    jagent, tagent, jbatch, tbatch, jstate, tstate, w = _setup()
    flops = t_device.flops_of(tagent.learner_step, tstate, tbatch, torch.from_numpy(w))
    cfg = tagent.config
    B, H, A, O = 8, 32, 1, 3
    bi, U, n = cfg.burnin, cfg.unroll, cfg.n_step
    Ta, Wia, Wha, Hda = 2 * B * O * H, 8 * B * H * H, 8 * B * H * H, 2 * B * H * A
    Tc, Mc, Wic, Whc, Hdc = 2 * B * O * H, 2 * B * (H + A) * H, 8 * B * H * H, \
        8 * B * H * H, 2 * B * H
    a, c = Ta + Wia + Wha + Hda, Tc + Mc + Wic + Whc + Hdc
    analytic = (2 * bi * (a + c) + (U + n) * (a + c)
                + U * c + U * c + U * (Mc + Wic + Hdc) + (U - 1) * Whc
                + U * (a + c) + U * a + U * (Wia + Hda) + (U - 1) * Wha
                + U * (Mc + Wic + Hdc) + (U - 1) * Whc)
    assert abs(flops - analytic) <= 0.01 * analytic, (flops, analytic)
    lowered = jax.jit(jagent.learner_step).lower(jstate, jbatch, jax.numpy.asarray(w))
    xla = j_device.flops_of(lowered)
    with capsys.disabled():
        print(f"\npendulum_tiny learner step: FlopCounterMode {flops:.0f}, analytic "
              f"{analytic}, XLA cost_analysis {xla} (ratio port/XLA "
              f"{None if not xla else flops / xla:.4f})")
    # The counted call ran for real: its outputs are the uncounted call's.
    out_counted, _ = t_device.count_flops(
        tagent.learner_step, tstate, tbatch, torch.from_numpy(w))
    out_plain = tagent.learner_step(tstate, tbatch, torch.from_numpy(w))
    for x, y in zip(out_counted[0].actor_params.values(),
                    out_plain[0].actor_params.values()):
        assert torch.equal(x, y)
    assert torch.equal(out_counted[1], out_plain[1])
    assert t_device.flops_of(lambda: torch.ones(3) + 1) is None


def test_trainer_run_counted_first_phase_is_bitwise(monkeypatch):
    """``Trainer.run`` runs its first train phase under the FLOP counter;
    the run is bitwise the same as one whose counter is a plain call, and
    the learn FLOPs counter adds the counted cost once per train phase."""
    from r2d2dpg_torch.configs import PENDULUM_TINY
    from r2d2dpg_torch.training import trainer as trainer_mod

    def run():
        t = PENDULUM_TINY.build("cpu")
        fill = t.window_fill_phases + t.replay_fill_phases
        return t.run(fill + 3, log_every=2, log_fn=lambda *_: None)

    counter = tobs.get_registry().get("r2d2dpg_device_learn_flops_total")
    before = counter.value if counter is not None else 0.0
    counted = run()
    counter = tobs.get_registry().get("r2d2dpg_device_learn_flops_total")
    per_phase = tobs.get_device_monitor()._learn_flops_per_dispatch
    assert per_phase > 0 and counter.value - before == 3 * per_phase
    monkeypatch.setattr(trainer_mod, "count_flops",
                        lambda fn, *a, **k: (fn(*a, **k), None))
    plain = run()
    from test_torch_sampler import _assert_states_bitwise

    _assert_states_bitwise(counted, plain)
