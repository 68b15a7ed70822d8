"""Topology-wide health verdicts: is this run healthy now, and if not, which part?

Port of ``r2d2dpg_tpu/obs/health.py`` (pure Python; copied so the port
imports nothing of the JAX package).  A small rule engine over the signals
already on the process's one scrape (the registry merged with the
``RemoteMirror``), with a machine-readable verdict::

    GET /health  ->  {"verdict": "ok" | "degraded" | "critical",
                      "findings": [{"rule", "severity", "detail",
                                    "value", "threshold"}, ...],
                      "t_wall": ...}

The rules, in evaluation order (``RULES`` adds the synthetic
``engine_error`` a raising rule degrades into):

- ``learner_starving``: fleet learner or sampler wait p99 over threshold;
- ``telem_stale``: an actor's or shard's TELEM staleness over threshold
  (only when TELEM pushes are expected);
- ``shard_skew``: one replay shard empty while the tier holds data;
- ``eviction_churn``: ring evictions/s over threshold (windowed rate);
- ``actors_down`` / ``shards_down``: live supervised processes below the
  spawn target (``critical`` at zero);
- ``recompile_churn``: new steady recompiles inside a window (the port's
  eager path publishes no ``r2d2dpg_device_steady_recompiles_total``, so
  the rule reads "signal absent" there);
- ``hbm_pressure``: a device's bytes in use over a fraction of its size;
- ``stale_experience``, ``priority_collapse``, ``untrained_churn``,
  ``actor_skew``: the experience-quality plane's judgements;
- ``serve_queue_saturated``, ``serve_shed_churn``: routed serving workers.

Windowed rates (``*_rate_min_dt_s``): polls closer than the minimum gap
re-judge the last full window, so a burst over a sub-second gap between
two polls cannot flap the verdict.  The verdict is the max severity; each
transition lands in the flight ring as a ``health_verdict`` event and
``r2d2dpg_health_{status,findings,rule_firing,transitions_total}`` put it
on the scrape.  Evaluation is pull-time and never raises: a rule that
cannot read its signal contributes nothing.
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from typing import Dict, List, Optional

from r2d2dpg_torch.obs.flight import flight_event
from r2d2dpg_torch.obs.registry import (
    Registry,
    RemoteMirror,
    get_registry,
    merge_remote,
)

VERDICT_OK = "ok"
VERDICT_DEGRADED = "degraded"
VERDICT_CRITICAL = "critical"
_SEVERITY = {VERDICT_OK: 0, VERDICT_DEGRADED: 1, VERDICT_CRITICAL: 2}

# The fixed rule namespace: every rule's firing state is exported as
# r2d2dpg_health_rule_firing{rule=...} including the ZEROS, so a cleared
# finding reads as an explicit 0, never as a vanished series.
RULES = (
    "learner_starving",
    "telem_stale",
    "shard_skew",
    "eviction_churn",
    "actors_down",
    "shards_down",
    "recompile_churn",
    "hbm_pressure",
    "stale_experience",
    "priority_collapse",
    "untrained_churn",
    "actor_skew",
    "serve_queue_saturated",
    "serve_shed_churn",
    # The synthetic finding a raising rule degrades into (never a 500):
    # exported like the real rules so a degraded verdict is always
    # attributable to SOME firing series on the scrape.
    "engine_error",
)


@dataclasses.dataclass
class HealthConfig:
    """Verdict thresholds.  Defaults are deliberately loose (a health
    endpoint that cries wolf on warm-up noise trains operators to ignore
    it); train.py exposes the two an operator actually tunes
    (``--health-wait-p99``, ``--health-stale-after``)."""

    learner_wait_p99_s: float = 0.5
    telem_stale_after_s: float = 10.0
    eviction_churn_per_s: float = 50.0
    # Eviction rate windows shorter than this re-judge the previous full
    # window: FIFO evictions land in whole-batch bursts, and a burst
    # divided by a sub-second poll gap is not a sustained rate.
    eviction_rate_min_dt_s: float = 5.0
    # Skew is only judged once the tier holds real data: a shard at 0
    # while the MEAN occupancy is below this floor is warm-up, not skew
    # (the rejoined-empty-shard absorb phase must not read as degraded —
    # the same fix class as the actor warm-up TELEM cadence).
    occupancy_skew_min_mean: float = 64.0
    expected_actors: int = 0  # 0 = rule disarmed
    expected_shard_procs: int = 0  # 0 = rule disarmed
    # Device plane (obs/device.py).  recompile_churn fires on ANY new
    # steady_recompile inside a window at the 0.0 default — one post-warm
    # re-key is already the bug class the sentinel exists for; polls
    # closer than the min dt re-judge the last full window (the
    # eviction_churn burst guard, same rationale).
    steady_recompiles_per_window: float = 0.0
    recompile_rate_min_dt_s: float = 5.0
    # hbm_pressure: in_use over this fraction of the device's reported
    # bytes_limit reads as "the next allocation bump OOMs".
    hbm_pressure_frac: float = 0.92
    # Staleness gauges arm at HELLO whether or not the peers were told to
    # push TELEM (actor/shard --telem-every rides --obs-fleet): on a run
    # without it every clock grows forever, and firing telem_stale there
    # would stamp every healthy non-obs-fleet run degraded.  train.py
    # sets this from the resolved --obs-fleet; the default keeps the
    # standalone-engine behavior (a gauge that exists is judged).
    telem_expected: bool = True
    # Experience-quality plane (obs/quality.py).  stale_experience judges
    # the policy-lag p99 only after the histogram holds a real sample
    # population: the first drained phases after min_replay legitimately
    # carry warm-up lag (actors filled replay while the learner sat on
    # version 0), and a p99 over a handful of observations is noise.
    quality_max_lag: float = 100.0
    quality_min_lag_count: float = 100.0
    # A true ESS/B is always positive (probs are positive), so 0 means
    # the gauge never armed — the floor only judges armed values.
    quality_ess_floor: float = 0.05
    # untrained_churn arms once a shard has evicted a real population;
    # the fraction alone would fire on the first tiny FIFO batch.
    quality_untrained_frac: float = 0.5
    quality_churn_min_evictions: float = 256.0
    # actor_skew needs >=2 actors with a trained-seqs ladder and a real
    # mean before min/mean is meaningful (the occupancy_skew_min_mean
    # warm-up posture, keyed on trained sequences instead of slots).
    quality_actor_skew_frac: float = 0.1
    quality_actor_skew_min_mean: float = 256.0
    # Serving scale-out plane (serving/router.py).  Queue depth
    # is judged per worker only once that worker has served >= 1 request
    # (warm-up exemption: admission legitimately piles while the first
    # bucket compiles); sheds are judged as a per-worker windowed rate
    # with the eviction_churn burst guard.
    serve_queue_saturated_frac: float = 0.9
    serve_shed_per_s: float = 1.0
    serve_shed_rate_min_dt_s: float = 5.0


def _samples(snap: Dict, name: str) -> List[Dict]:
    entry = snap.get(name)
    if not isinstance(entry, dict):
        return []
    samples = entry.get("samples", ())
    return [s for s in samples if isinstance(s, dict)]


def _per_label_max(snap: Dict, name: str, label: str) -> Dict[object, float]:
    """One value per ``label`` from a possibly-duplicated family: a
    series can appear TWICE in a merged snapshot — a local copy and a
    TELEM-mirrored copy share the metric name (deployment, not
    semantics) — so samples dedupe on the label with max() (for monotone
    counters the larger IS the fresher copy; for gauges it errs toward
    the worse reading).  Samples without the label keep their own slots."""
    per_label: Dict[object, float] = {}
    for i, s in enumerate(_samples(snap, name)):
        v = _finite(s.get("value"))
        if v is None:
            continue
        labels = s.get("labels")
        key = (
            labels.get(label)
            if isinstance(labels, dict) and label in labels
            else ("unlabelled", i)
        )
        per_label[key] = max(per_label.get(key, 0.0), v)
    return per_label


def _per_shard_max(snap: Dict, name: str) -> Dict[object, float]:
    """One value per shard — the learner's advert mirror and the shard
    proc's TELEM copy share metric names; see ``_per_label_max``."""
    return _per_label_max(snap, name, "shard")


def _finite(v) -> Optional[float]:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return None
    return f if math.isfinite(f) else None


class HealthEngine:
    """The rule engine behind ``GET /health``.

    ``evaluate()`` is cheap (one registry snapshot + mirror merge) and
    thread-safe; the exporter calls it per request.  State across calls:
    the last verdict (for transition flight events) and the last
    eviction total/timestamp (the churn rule needs a rate, and counters
    only carry totals)."""

    def __init__(
        self,
        config: Optional[HealthConfig] = None,
        *,
        registry: Optional[Registry] = None,
        mirror: Optional[RemoteMirror] = None,
    ):
        self.config = config or HealthConfig()
        self.registry = registry if registry is not None else get_registry()
        self.mirror = mirror
        self._lock = threading.Lock()
        self._last_verdict: Optional[str] = None
        self._evict_last: Optional[tuple] = None  # (t_mono, total)
        self._evict_rate: Optional[float] = None  # last full-window rate
        self._recompile_last: Optional[tuple] = None  # (t_mono, total)
        self._recompile_new: Optional[float] = None  # last full window's new
        # serve_shed_churn keeps one rate window PER worker label (the
        # rule's whole point is naming the shedding device).
        self._serve_shed_last: Dict[object, tuple] = {}  # w -> (t, total)
        self._serve_shed_rate: Dict[object, float] = {}  # w -> full-window
        self._rules = (
            self._rule_learner_starving,
            self._rule_telem_stale,
            self._rule_shard_skew,
            self._rule_eviction_churn,
            self._rule_procs_down,
            self._rule_recompile_churn,
            self._rule_hbm_pressure,
            self._rule_stale_experience,
            self._rule_priority_collapse,
            self._rule_untrained_churn,
            self._rule_actor_skew,
            self._rule_serve_queue_saturated,
            self._rule_serve_shed_churn,
        )
        reg = self.registry
        self._obs_status = reg.gauge(
            "r2d2dpg_health_status",
            "the /health verdict as a level: 0 ok, 1 degraded, 2 critical "
            "(refreshed at each /health evaluation)",
        )
        self._obs_findings = reg.gauge(
            "r2d2dpg_health_findings",
            "live /health findings at the last evaluation",
        )
        self._obs_rule = reg.gauge(
            "r2d2dpg_health_rule_firing",
            "1 while this health rule has a live finding, else 0",
            labelnames=("rule",),
        )
        self._obs_transitions = reg.counter(
            "r2d2dpg_health_transitions_total",
            "verdict transitions (each one also lands in flight.jsonl as "
            "a health_verdict event)",
        )

    # ----------------------------------------------------------------- rules
    def _rule_learner_starving(self, snap, findings) -> None:
        for name in (
            "r2d2dpg_fleet_learner_wait_seconds",
            "r2d2dpg_sampler_wait_seconds",
        ):
            for s in _samples(snap, name):
                if not s.get("count"):
                    continue
                p99 = _finite(s.get("p99"))
                if p99 is not None and p99 > self.config.learner_wait_p99_s:
                    findings.append(
                        {
                            "rule": "learner_starving",
                            "severity": VERDICT_DEGRADED,
                            "detail": f"{name} p99 over threshold — the "
                            "learner is waiting on experience",
                            "value": p99,
                            "threshold": self.config.learner_wait_p99_s,
                        }
                    )

    def _rule_telem_stale(self, snap, findings) -> None:
        if not self.config.telem_expected:
            return  # no TELEM cadence armed: a growing clock is not a wedge
        for name, unit in (
            ("r2d2dpg_fleet_telem_staleness_seconds", "actor"),
            ("r2d2dpg_shard_telem_staleness_seconds", "shard"),
        ):
            for s in _samples(snap, name):
                v = _finite(s.get("value"))
                if v is not None and v > self.config.telem_stale_after_s:
                    who = s.get("labels", {}).get(unit, "?")
                    findings.append(
                        {
                            "rule": "telem_stale",
                            "severity": VERDICT_DEGRADED,
                            "detail": f"{unit} {who} TELEM stale — wedged, "
                            "partitioned, or dead (its mirrored series "
                            "hold last values)",
                            "value": v,
                            "threshold": self.config.telem_stale_after_s,
                        }
                    )

    def _rule_shard_skew(self, snap, findings) -> None:
        # Dedupe per shard label (see _per_shard_max): raw samples would
        # defeat the len>=2 single-shard guard, and a lagging TELEM copy
        # (0 from the forced HELLO push) beside a climbing advert would
        # read as a spuriously empty shard.  max() errs toward "holds
        # data": this rule exists to flag an empty shard, and either
        # copy showing occupancy disproves that.
        occ = list(
            _per_shard_max(snap, "r2d2dpg_replay_shard_occupancy").values()
        )
        if len(occ) < 2:
            return
        mean = sum(occ) / len(occ)
        if mean >= self.config.occupancy_skew_min_mean and min(occ) == 0.0:
            findings.append(
                {
                    "rule": "shard_skew",
                    "severity": VERDICT_DEGRADED,
                    "detail": "a replay shard sits empty while the tier "
                    "holds data — routing/quota skew or a shard not "
                    "being fed",
                    "value": min(occ),
                    "threshold": mean,
                }
            )

    def _rule_eviction_churn(self, snap, findings) -> None:
        # Both copies track one monotone quantity, so _per_shard_max's
        # dedupe picks the fresher (larger); summing raw samples would
        # double the rate and fire the rule at half the threshold.
        per_shard = _per_shard_max(
            snap, "r2d2dpg_replay_shard_evictions_total"
        )
        if not per_shard:
            return
        total = sum(per_shard.values())
        now = time.monotonic()
        with self._lock:
            last = self._evict_last
            if (
                last is not None
                and now - last[0] < self.config.eviction_rate_min_dt_s
            ):
                # Closely spaced polls (autoscaler racing an operator
                # curl) re-judge the LAST full window instead of a
                # fresh sub-second one: a single FIFO batch eviction —
                # e.g. 64 slots in one instant — over a 0.5s gap reads
                # as 128/s and flaps the verdict on a non-event.
                rate = self._evict_rate
            else:
                if last is not None and now > last[0]:
                    self._evict_rate = max(total - last[1], 0.0) / (
                        now - last[0]
                    )
                self._evict_last = (now, total)
                rate = self._evict_rate if last is not None else None
        if rate is None:
            return  # first sighting: no window yet
        if rate > self.config.eviction_churn_per_s:
            findings.append(
                {
                    "rule": "eviction_churn",
                    "severity": VERDICT_DEGRADED,
                    "detail": "replay rings are recycling experience "
                    "faster than the threshold — replay undersized for "
                    "the collection rate",
                    "value": rate,
                    "threshold": self.config.eviction_churn_per_s,
                }
            )

    def _rule_recompile_churn(self, snap, findings) -> None:
        samples = _samples(
            snap, "r2d2dpg_device_steady_recompiles_total"
        )
        if not samples:
            return  # no device monitor in this process: rule disarmed
        total = max(
            (v for v in (_finite(s.get("value")) for s in samples)
             if v is not None),
            default=None,
        )
        if total is None:
            return
        now = time.monotonic()
        with self._lock:
            last = self._recompile_last
            if (
                last is not None
                and now - last[0] < self.config.recompile_rate_min_dt_s
            ):
                # Sub-window poll gap: re-judge the last FULL window (the
                # eviction_churn burst guard) so an operator curl racing
                # the autoscaler cannot flap the verdict.
                new = self._recompile_new
            else:
                if last is not None:
                    self._recompile_new = max(total - last[1], 0.0)
                else:
                    # First sighting: a counter that is ALREADY nonzero
                    # is live evidence (the drill fired before the first
                    # /health poll), not a rate — judge the absolute
                    # total, and keep judging it (sub-window re-polls
                    # included) until a full quiet window clears it.
                    self._recompile_new = total
                self._recompile_last = (now, total)
                new = self._recompile_new
        if new is None:
            return
        if new > self.config.steady_recompiles_per_window:
            findings.append(
                {
                    "rule": "recompile_churn",
                    "severity": VERDICT_DEGRADED,
                    "detail": "steady-state recompiles: a learn/drain "
                    "program's avals re-keyed after warm-up (see "
                    "steady_recompile flight events for the program "
                    "label) — each one is a silent multi-second stall",
                    "value": new,
                    "threshold": self.config.steady_recompiles_per_window,
                }
            )

    def _rule_hbm_pressure(self, snap, findings) -> None:
        limits: Dict[object, float] = {}
        for s in _samples(snap, "r2d2dpg_device_hbm_bytes_limit"):
            v = _finite(s.get("value"))
            labels = s.get("labels")
            if v and v > 0 and isinstance(labels, dict):
                limits[labels.get("device")] = v
        if not limits:
            return  # CPU fallback reports no capacity: never degrading
        for s in _samples(snap, "r2d2dpg_device_hbm_bytes_in_use"):
            v = _finite(s.get("value"))
            labels = s.get("labels")
            if v is None or not isinstance(labels, dict):
                continue
            limit = limits.get(labels.get("device"))
            if limit is None:
                continue
            if v > self.config.hbm_pressure_frac * limit:
                findings.append(
                    {
                        "rule": "hbm_pressure",
                        "severity": VERDICT_DEGRADED,
                        "detail": f"device {labels.get('device')} HBM in "
                        "use over the headroom threshold — the next "
                        "drain-width/batch allocation bump OOMs",
                        "value": v,
                        "threshold": self.config.hbm_pressure_frac * limit,
                    }
                )

    def _rule_procs_down(self, snap, findings) -> None:
        for name, rule, expected in (
            (
                "r2d2dpg_fleet_actors_alive",
                "actors_down",
                self._expected_actors(snap),
            ),
            (
                "r2d2dpg_shard_alive",
                "shards_down",
                self.config.expected_shard_procs,
            ),
        ):
            if expected <= 0:
                continue
            samples = _samples(snap, name)
            if not samples:
                continue  # no supervisor in this process: rule disarmed
            alive = _finite(samples[0].get("value"))
            if alive is None or alive >= expected:
                continue
            findings.append(
                {
                    "rule": rule,
                    "severity": (
                        VERDICT_CRITICAL if alive == 0 else VERDICT_DEGRADED
                    ),
                    "detail": f"{name}: live supervised processes below "
                    "the spawn target",
                    "value": alive,
                    "threshold": float(expected),
                }
            )

    def _expected_actors(self, snap) -> int:
        # The scrape itself carries the target when the ingest server
        # registered it (r2d2dpg_fleet_actors_expected); the config value
        # is the fallback for processes without an ingest server.
        for s in _samples(snap, "r2d2dpg_fleet_actors_expected"):
            v = _finite(s.get("value"))
            if v is not None and v > 0:
                return int(v)
        return self.config.expected_actors

    def _rule_stale_experience(self, snap, findings) -> None:
        # Provenance-absent frames never observe into this histogram
        # (obs/quality.py disarms the fold on the -1 sentinel), so an
        # old-schema fleet simply has no samples here and stays green.
        for s in _samples(snap, "r2d2dpg_quality_policy_lag"):
            count = _finite(s.get("count"))
            if not count or count < self.config.quality_min_lag_count:
                continue  # warm-up: too few lag observations to judge
            p99 = _finite(s.get("p99"))
            if p99 is not None and p99 > self.config.quality_max_lag:
                findings.append(
                    {
                        "rule": "stale_experience",
                        "severity": VERDICT_DEGRADED,
                        "detail": "policy-lag p99 over --quality-max-lag — "
                        "the learner is training on experience collected "
                        "too many param versions ago (publish cadence, "
                        "actor pull wedge, or replay far oversized)",
                        "value": p99,
                        "threshold": self.config.quality_max_lag,
                    }
                )

    def _rule_priority_collapse(self, snap, findings) -> None:
        for s in _samples(snap, "r2d2dpg_quality_ess_frac"):
            v = _finite(s.get("value"))
            if v is None or v <= 0.0:
                continue  # never armed: a real ESS/B is strictly positive
            if v < self.config.quality_ess_floor:
                findings.append(
                    {
                        "rule": "priority_collapse",
                        "severity": VERDICT_DEGRADED,
                        "detail": "ESS/B of trained batches under the "
                        "floor — the priority distribution collapsed onto "
                        "a handful of slots (alpha too hot or a priority "
                        "spike recycling the same transitions)",
                        "value": v,
                        "threshold": self.config.quality_ess_floor,
                    }
                )

    def _rule_untrained_churn(self, snap, findings) -> None:
        # Dedupe per shard label (see _per_shard_max): the learner's
        # advert mirror and a shard proc's TELEM copy share these names.
        totals = _per_shard_max(
            snap, "r2d2dpg_quality_evicted_unsampled_total"
        )
        fracs = _per_shard_max(
            snap, "r2d2dpg_quality_evicted_unsampled_frac"
        )
        for shard, frac in fracs.items():
            if (
                totals.get(shard, 0.0)
                < self.config.quality_churn_min_evictions
            ):
                continue  # warm-up: not enough evictions to call a trend
            if frac > self.config.quality_untrained_frac:
                findings.append(
                    {
                        "rule": "untrained_churn",
                        "severity": VERDICT_DEGRADED,
                        "detail": f"shard {shard} is evicting experience "
                        "the learner never sampled — collection outruns "
                        "training reach (replay undersized or sample "
                        "quota starving this shard)",
                        "value": frac,
                        "threshold": self.config.quality_untrained_frac,
                    }
                )

    def _rule_actor_skew(self, snap, findings) -> None:
        # Dedupe per actor label with max() (monotone counters: the
        # larger copy is the fresher) — the mirror/TELEM duplication
        # that motivates _per_shard_max applies to actor series too.
        per_actor: Dict[object, float] = {}
        for s in _samples(snap, "r2d2dpg_quality_trained_seqs_total"):
            v = _finite(s.get("value"))
            labels = s.get("labels")
            if v is None or not isinstance(labels, dict):
                continue
            actor = labels.get("actor")
            if actor is None:
                continue
            per_actor[actor] = max(per_actor.get(actor, 0.0), v)
        if len(per_actor) < 2:
            return  # skew needs a ladder: single-actor runs never fire
        mean = sum(per_actor.values()) / len(per_actor)
        if mean < self.config.quality_actor_skew_min_mean:
            return  # warm-up: the fleet has not trained enough to judge
        low_actor, low = min(per_actor.items(), key=lambda kv: kv[1])
        threshold = self.config.quality_actor_skew_frac * mean
        if low < threshold:
            findings.append(
                {
                    "rule": "actor_skew",
                    "severity": VERDICT_DEGRADED,
                    "detail": f"actor {low_actor} trained-seqs far below "
                    "the fleet mean — its lane of the sigma ladder is "
                    "not reaching training (dead env pool, wedged "
                    "actor, or routing starvation)",
                    "value": low,
                    "threshold": threshold,
                }
            )

    def _rule_serve_queue_saturated(self, snap, findings) -> None:
        # Dedupe every family per worker label (_per_label_max): a future
        # cross-process serving tier mirrors these series the same way
        # shard TELEM does, and gauges err toward the worse reading.
        depths = _per_label_max(snap, "r2d2dpg_serve_queue_depth", "worker")
        if not depths:
            return  # no routed serving workers in this process: disarmed
        limits = _per_label_max(snap, "r2d2dpg_serve_queue_limit", "worker")
        served = _per_label_max(
            snap, "r2d2dpg_serve_requests_total", "worker"
        )
        for worker, depth in sorted(depths.items(), key=str):
            limit = limits.get(worker)
            if limit is None or limit <= 0:
                continue
            if served.get(worker, 0.0) <= 0:
                # Warm-up exemption: admission piles up while this
                # worker's first bucket compiles — saturation is only a
                # finding once it has proven it can drain at all.
                continue
            threshold = self.config.serve_queue_saturated_frac * limit
            if depth >= threshold:
                findings.append(
                    {
                        "rule": "serve_queue_saturated",
                        "severity": VERDICT_DEGRADED,
                        "detail": f"serving worker {worker} queue depth "
                        "at the saturation fraction of its admission "
                        "bound — one burst away from shedding (grow "
                        "--serve-workers, raise --max-queue, or slow "
                        "the client)",
                        "value": depth,
                        "threshold": threshold,
                    }
                )

    def _rule_serve_shed_churn(self, snap, findings) -> None:
        # Sheds are labelled {worker, code}; dedupe per cell with max()
        # (monotone counters, mirror-safe), then sum a worker's codes —
        # the rule judges "this worker is shedding", whatever the mode.
        cells: Dict[tuple, float] = {}
        for s in _samples(snap, "r2d2dpg_serve_sheds_total"):
            v = _finite(s.get("value"))
            labels = s.get("labels")
            if v is None or not isinstance(labels, dict):
                continue
            worker = labels.get("worker")
            if worker is None:
                continue
            key = (worker, labels.get("code"))
            cells[key] = max(cells.get(key, 0.0), v)
        if not cells:
            return  # no routed serving workers in this process: disarmed
        per_worker: Dict[object, float] = {}
        for (worker, _code), v in cells.items():
            per_worker[worker] = per_worker.get(worker, 0.0) + v
        now = time.monotonic()
        for worker in sorted(per_worker, key=str):
            total = per_worker[worker]
            with self._lock:
                last = self._serve_shed_last.get(worker)
                if (
                    last is not None
                    and now - last[0] < self.config.serve_shed_rate_min_dt_s
                ):
                    # Sub-window poll gap: re-judge the last FULL window
                    # (the eviction_churn burst guard) — one shed burst
                    # over a 0.5s curl gap is not a sustained rate.
                    rate = self._serve_shed_rate.get(worker)
                else:
                    if last is not None and now > last[0]:
                        self._serve_shed_rate[worker] = max(
                            total - last[1], 0.0
                        ) / (now - last[0])
                    self._serve_shed_last[worker] = (now, total)
                    rate = (
                        self._serve_shed_rate.get(worker)
                        if last is not None
                        else None
                    )
            if rate is None:
                continue  # first sighting of this worker: no window yet
            if rate > self.config.serve_shed_per_s:
                findings.append(
                    {
                        "rule": "serve_shed_churn",
                        "severity": VERDICT_DEGRADED,
                        "detail": f"serving worker {worker} is shedding "
                        "at a sustained rate — its admission bound or "
                        "session slab is persistently full (grow "
                        "--serve-workers or per-worker capacity)",
                        "value": rate,
                        "threshold": self.config.serve_shed_per_s,
                    }
                )

    # -------------------------------------------------------------- evaluate
    def evaluate(self) -> Dict:
        """One verdict over the current registry (+ mirror) state.  Never
        raises: a rule that cannot read its signal contributes nothing
        (absence of evidence is not degradation — staleness gauges exist
        so absence itself becomes a visible signal)."""
        snap = self.registry.snapshot()
        if self.mirror is not None:
            sources = self.mirror.sources()
            if sources:
                snap = merge_remote(snap, sources)
        findings: List[Dict] = []
        for rule in self._rules:
            try:
                rule(snap, findings)
            except Exception as e:  # noqa: BLE001 - verdict isolation
                findings.append(
                    {
                        "rule": "engine_error",
                        "severity": VERDICT_DEGRADED,
                        "detail": f"health rule failed: "
                        f"{type(e).__name__}: {e}",
                        "value": None,
                        "threshold": None,
                    }
                )
        verdict = VERDICT_OK
        for f in findings:
            if _SEVERITY[f["severity"]] > _SEVERITY[verdict]:
                verdict = f["severity"]
        firing = {f["rule"] for f in findings}
        self._obs_status.set(_SEVERITY[verdict])
        self._obs_findings.set(len(findings))
        for rule in RULES:
            self._obs_rule.labels(rule=rule).set(1.0 if rule in firing else 0.0)
        with self._lock:
            previous = self._last_verdict
            transition = verdict != previous
            self._last_verdict = verdict
        if transition:
            # Every transition is post-mortem evidence: flight.jsonl says
            # WHEN the run degraded and when it recovered, with the rules
            # that drove the change.
            self._obs_transitions.inc()
            flight_event(
                "health_verdict",
                verdict=verdict,
                previous=previous,
                rules=sorted(firing),
            )
        return {
            "verdict": verdict,
            "findings": findings,
            "t_wall": time.time(),
        }
