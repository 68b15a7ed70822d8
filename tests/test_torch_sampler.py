"""Port parity: in-network experience sampling (``--replay-shards N``).

``r2d2dpg_torch/replay/sharded.py`` and ``r2d2dpg_torch/fleet/sampler.py``
against ``r2d2dpg_tpu/replay/sharded.py`` and ``r2d2dpg_tpu/fleet/sampler.py``
on the same seeded numpy inputs, at pendulum_tiny width.

Tolerances: everything on the host side is BITWISE (both packages draw
with numpy's ``default_rng``): a shard's slots, generations, within-shard
probabilities, provenance and stored sequences; ``shard_quotas``,
``combine_probs``, ``actor_code`` and ``shard_for_actor``; one loopback
pull's SAMPLE_REQ/BATCH/PRIO frame bytes, its permutation, its handles and
its float64 and float32 combined probabilities.  The two-level draw's
frequencies match the central distribution within 0.02 absolute on
exact-integer priorities (and its combined probabilities within 1e-12
relative).  The learn step (K = 1 and K = 4, plain and TD3) against JAX
``_learn_impl`` with converted params and the smoothing normals JAX draws:
params, priorities and metrics within the trainer parity tolerance
``atol=1e-5, rtol=1e-4``.  ``--replay-shards 1 --actors 0`` is bitwise
``Trainer.run``; the CLI refusals are the JAX messages, character for
character.
"""

import dataclasses
import functools
import queue
import re
import threading

import jax
import numpy as np
import pytest
import torch

from r2d2dpg_tpu.configs import PENDULUM_TINY as J_TINY
from r2d2dpg_tpu.fleet import FleetConfig as JFleetConfig
from r2d2dpg_tpu.fleet import SamplerLearner as JSamplerLearner
from r2d2dpg_tpu.fleet import shard_for_actor as j_shard_for_actor
from r2d2dpg_tpu.replay import sharded as jsh
from r2d2dpg_tpu.replay.arena import SequenceBatch as JSequenceBatch
from r2d2dpg_tpu.replay.arena import StagedSequences as JStaged
from r2d2dpg_torch.configs import PENDULUM_TINY
from r2d2dpg_torch.convert import net_params_from_flax, train_state_from_jax
from r2d2dpg_torch.fleet import (
    FleetActor,
    FleetConfig,
    SamplerLearner,
    ShardSet,
    shard_for_actor,
    transport,
    wire,
)
from r2d2dpg_torch.fleet.ingest import IngestServer
from r2d2dpg_torch.fleet.transport import (
    K_ACK,
    K_HELLO,
    K_SEQS,
    pack_hello,
    recv_frame,
    send_frame,
    send_frame_parts,
    unpack_obj,
)
from r2d2dpg_torch.replay import sharded as psh
from r2d2dpg_torch.replay.arena import SequenceBatch, StagedSequences
from r2d2dpg_torch.training import ReplayDraws
from r2d2dpg_torch.utils.codes import OK
from test_torch_pipeline import _assert_states_bitwise

pytestmark = pytest.mark.sampler

TOL = dict(atol=1e-5, rtol=1e-4)
N_TRAIN = 6
PARAM_FIELDS = ("actor_params", "critic_params", "target_actor_params",
                "target_critic_params")


# ---------------------------------------------------------------- helpers
@functools.cache
def _template():
    """The port trainer's arena storage at pendulum_tiny's learner shapes:
    numpy ``[capacity, ...]`` leaves, the template of a staged batch."""
    data = PENDULUM_TINY.build("cpu").init().arena.data
    return {
        "fields": {f: getattr(data, f).numpy() for f in ("obs", "action", "reward",
                                                        "discount", "reset")},
        "carries": {k: tuple(x.numpy() for x in v) for k, v in data.carries.items()},
    }


def _pair(rng, b, *, prios=True, provenance=True):
    """The same random staged batch as a JAX and as a port
    ``StagedSequences`` (numpy leaves, shared arrays)."""
    template = _template()
    f = {k: rng.normal(size=(b,) + v.shape[1:]).astype(v.dtype)
         for k, v in template["fields"].items()}
    f["discount"] = np.ones_like(f["discount"])
    f["reset"] = (rng.random(f["reset"].shape) < 0.1).astype(f["reset"].dtype)
    carries = {k: tuple(rng.normal(size=(b,) + x.shape[1:]).astype(x.dtype) for x in v)
               for k, v in template["carries"].items()}
    extra = dict(
        priorities=rng.uniform(0.1, 4.0, size=b).astype(np.float32) if prios else None,
        behavior_version=rng.integers(0, 5, size=b) if provenance else None,
        collect_id=rng.integers(0, 9, size=b) if provenance else None,
    )
    return (JStaged(seq=JSequenceBatch(**f, carries=carries), **extra),
            StagedSequences(seq=SequenceBatch(**f, carries=carries), **extra))


def _leaves(seq):
    out = [getattr(seq, f) for f in ("obs", "action", "reward", "discount", "reset")]
    for k in sorted(seq.carries):
        out.extend(seq.carries[k])
    return [np.asarray(x) for x in out]


def _assert_seq_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------ the shard ring
def test_replay_shard_equals_jax_bitwise():
    """Adds past the ring (evictions), max-priority entry, draws, a
    write-back with one stale generation, and an unprioritized shard:
    every array and count equal to the JAX shard's."""
    rng = np.random.default_rng(0)
    for prioritized in (True, False):
        js = jsh.ReplayShard(16, alpha=0.6, prioritized=prioritized, shard_id=2)
        ps = psh.ReplayShard(16, alpha=0.6, prioritized=prioritized, shard_id=2)
        rj, rp = np.random.default_rng(5), np.random.default_rng(5)
        for i in range(7):
            j, p = _pair(rng, 3, prios=i % 3 != 0, provenance=i % 2 == 0)
            kw = dict(behavior=j.behavior_version, collect=j.collect_id,
                      actor=None if i == 1 else psh.actor_code(i))
            assert js.add(j.seq, j.priorities, **kw) == ps.add(p.seq, p.priorities, **kw)
            sj, sp = js.sample(5, rj), ps.sample(5, rp)
            for f in ("slots", "gens", "probs", "behavior", "collect", "actors"):
                np.testing.assert_array_equal(getattr(sj, f), getattr(sp, f), err_msg=f)
                assert getattr(sj, f).dtype == getattr(sp, f).dtype
            _assert_seq_equal(sj.seq, sp.seq)
            new = rng.uniform(0.0, 3.0, size=5)
            gens = sj.gens.copy()
            gens[0] -= 1  # one stale handle: ignored on both sides
            assert js.update_priorities(sj.slots, gens, new) == \
                ps.update_priorities(sp.slots, gens, new)
        for name in ("_priority", "_scaled", "_generation", "_behavior", "_collect",
                     "_actor", "_ever_sampled"):
            np.testing.assert_array_equal(getattr(js, name), getattr(ps, name))
        for name in ("evictions_total", "evicted_unsampled_total", "total_added"):
            assert getattr(js, name) == getattr(ps, name)
        assert js.occupancy() == ps.occupancy()
        assert js.priority_sum() == ps.priority_sum()
        assert js.scaled_sum() == ps.scaled_sum()
        assert ps.evictions_total > 0


def test_replay_shard_refusals_equal_jax():
    j, p = _pair(np.random.default_rng(1), 2)
    for mod in (jsh, psh):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            mod.ReplayShard(0)
        with pytest.raises(ValueError, match="is empty"):
            mod.ReplayShard(4).sample(1, np.random.default_rng(0))
    ps = psh.ReplayShard(4)
    ps.add(p.seq, p.priorities)
    with pytest.raises(ValueError, match="outside shard capacity"):
        ps.update_priorities(np.array([4]), np.array([1]), np.array([1.0]))
    with pytest.raises(ValueError, match="outside shard capacity"):
        ps.update_priorities(np.array([-1]), np.array([1]), np.array([1.0]))


@pytest.mark.parametrize("sums", [[0.0, 2.0, 6.0], [1.5, 1.5], [3.0], [0.25, 0.0, 0.5, 7.0]])
def test_shard_quotas_and_combine_probs_equal_jax(sums):
    for seed in range(3):
        q_j = jsh.shard_quotas(sums, 1000, np.random.default_rng(seed))
        q_p = psh.shard_quotas(sums, 1000, np.random.default_rng(seed))
        np.testing.assert_array_equal(q_j, q_p)
        assert q_p.sum() == 1000 and all(q_p[np.asarray(sums) == 0] == 0)
    within = np.random.default_rng(4).random(9)
    np.testing.assert_array_equal(jsh.combine_probs(within, sums[-1], sum(sums)),
                                  psh.combine_probs(within, sums[-1], sum(sums)))
    with pytest.raises(ValueError, match="empty"):
        psh.shard_quotas([0.0, 0.0], 8, np.random.default_rng(0))
    with pytest.raises(ValueError, match="negative"):
        psh.shard_quotas([-1.0, 2.0], 8, np.random.default_rng(0))


@pytest.mark.parametrize("actor", [0, 3, 7, "7", "12", "-3", "learner-0", "host-a/2", "x"])
def test_actor_code_and_routing_equal_jax(actor):
    assert psh.actor_code(actor) == jsh.actor_code(actor)
    assert psh.actor_code(actor) != -1
    for n in (1, 2, 3, 5):
        assert shard_for_actor(actor, n) == j_shard_for_actor(actor, n)
        assert 0 <= shard_for_actor(actor, n) < n


def test_two_level_frame_path_sampling_equivalence():
    """Draws through the port's ShardSet, the SAMPLE_REQ/BATCH codecs,
    the quotas and the combined probabilities reproduce the central
    proportional distribution on exact-integer priorities."""
    prios = np.array([1.0, 2.0, 3.0, 6.0, 4.0, 8.0], np.float64)
    shards = ShardSet(2, 8, alpha=1.0, prioritized=True)
    rng0 = np.random.default_rng(1)
    for shard_id, block in ((0, prios[:3]), (1, prios[3:])):
        _, p = _pair(rng0, 3, provenance=False)
        seq = dataclasses.replace(
            p.seq, reward=np.repeat(block.astype(np.float32)[:, None],
                                    p.seq.reward.shape[1], 1))
        shards.shards[shard_id].add(seq, block)
    packer, unpacker = wire.TreePacker(wire.WireConfig()), wire.TreeUnpacker()

    def roundtrip(parts):
        return unpacker.unpack(b"".join(bytes(x) for x in parts))

    rng = np.random.default_rng(0)
    counts = {}
    n_rounds, per_round = 300, 32
    total = float(shards.scaled_sums().sum())
    for _ in range(n_rounds):
        quotas = psh.shard_quotas(shards.scaled_sums(), per_round, rng)
        for shard_id, quota in enumerate(quotas):
            if quota == 0:
                continue
            req = wire.unpack_sample_req(roundtrip(wire.pack_sample_req(
                packer, req_id=1, shard=shard_id, quota=int(quota))))
            shard = shards.shards[req["shard"]]
            s = shard.sample(req["quota"], rng)
            resp = wire.unpack_shard_batch(roundtrip(wire.pack_shard_batch(
                packer, req_id=1, shard=shard_id,
                staged=StagedSequences(seq=s.seq, priorities=None),
                slots=s.slots, gens=s.gens, probs=s.probs,
                priority_sum=shard.scaled_sum(), occupancy=shard.occupancy())))
            got = psh.combine_probs(resp["probs"], shard.scaled_sum(), total)
            keys = resp["staged"].seq.reward[:, 0].astype(np.float64)
            np.testing.assert_allclose(got, keys / prios.sum(), rtol=1e-12)
            for k in keys:
                counts[float(k)] = counts.get(float(k), 0) + 1
    draws = n_rounds * per_round
    freq = np.array([counts.get(float(p), 0) / draws for p in prios])
    np.testing.assert_allclose(freq, prios / prios.sum(), atol=0.02)


# ----------------------------------------------------- one loopback pull
def _recording(learner, frames):
    plain = learner._roundtrip

    def roundtrip(unpacker, parts):
        frames.append(b"".join(bytes(x) for x in parts))
        return plain(unpacker, parts)

    learner._roundtrip = roundtrip


@pytest.fixture(scope="module")
def jax_tiny_trainer():
    return J_TINY.build()


def test_loopback_pull_and_write_back_equal_jax_bitwise(jax_tiny_trainer):
    """The same adds into a JAX and a port 2-shard loopback, then two
    phases of pull + write-back from the same seed: every SAMPLE_REQ,
    BATCH and PRIO frame byte-equal, the permuted sequences, handles,
    float64 and float32 combined probabilities and occupancy equal, and
    the shards' rings equal after the write-back."""
    jl = JSamplerLearner(jax_tiny_trainer, JFleetConfig(num_actors=3), num_shards=2)
    pl = SamplerLearner(PENDULUM_TINY.build("cpu"), FleetConfig(num_actors=3), num_shards=2)
    rng = np.random.default_rng(11)
    for i in range(9):
        j, p = _pair(rng, 4, prios=i != 4, provenance=i != 2)
        actor = str(i % 3)
        stats = {"env_steps_delta": 4.0, "ep_return_sum": -1.0, "ep_count": 1.0}
        jl.shards.add(jl.shards.route(actor), {"staged": j, "actor_id": actor, **stats})
        pl.shards.add(pl.shards.route(actor), {"staged": p, "actor_id": actor, **stats})
    assert jl.shards.pop_stats() == pl.shards.pop_stats()
    fj, fp = [], []
    _recording(jl, fj)
    _recording(pl, fp)
    rj, rp = np.random.default_rng(3), np.random.default_rng(3)
    n = 3 * 8
    for phase in range(2):
        seq_j, prob_j, h_j, occ_j = jl._pull_phase_batches(n, rj)
        seq_p, prob_p, h_p, occ_p = pl._pull_phase_batches(n, rp)
        _assert_seq_equal(seq_j, seq_p)
        assert prob_p.dtype == np.float64
        np.testing.assert_array_equal(prob_j, prob_p)
        np.testing.assert_array_equal(prob_j.astype(np.float32), prob_p.astype(np.float32))
        for a, b in zip(h_j, h_p):
            np.testing.assert_array_equal(a, b)
        assert occ_j == occ_p == 36
        prios = np.random.default_rng(phase).uniform(0.0, 5.0, size=n).astype(np.float32)
        jl._write_back(h_j, prios)
        pl._write_back(h_p, prios)
        for sj, sp in zip(jl.shards.shards, pl.shards.shards):
            for name in ("_priority", "_scaled", "_generation", "_ever_sampled"):
                np.testing.assert_array_equal(getattr(sj, name), getattr(sp, name))
    assert len(fp) == len(fj) and all(a == b for a, b in zip(fj, fp))
    assert pl.sample_bytes_total == jl.sample_bytes_total > 0
    # The permutation really reorders the shards' blocks.
    assert not np.all(np.diff(h_p[0]) >= 0)


def test_pulled_batch_reaches_the_device_in_one_copy(monkeypatch):
    """``_place`` makes one host-to-device copy (one ``Tensor.to``) of the
    whole pulled batch and its float32 probabilities, as ``[K, B]`` views."""
    config = dataclasses.replace(PENDULUM_TINY, trainer=dataclasses.replace(
        PENDULUM_TINY.trainer, learner_steps=4))
    pl = SamplerLearner(config.build("cpu"), FleetConfig(num_actors=1), num_shards=1)
    _, p = _pair(np.random.default_rng(2), 32)
    probs = np.random.default_rng(3).random(32)
    calls = []
    plain = torch.Tensor.to

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return plain(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "to", counting)
    seqs, pr = pl._place(p.seq, probs)
    monkeypatch.undo()
    assert len(calls) == 1 and len(calls[0]) == 1
    assert pr.shape == (4, 8) and pr.dtype == torch.float32
    np.testing.assert_array_equal(pr.numpy().ravel(), probs.astype(np.float32))
    assert seqs.obs.shape == (4, 8) + p.seq.obs.shape[1:]
    np.testing.assert_array_equal(seqs.obs.numpy().reshape(p.seq.obs.shape), p.seq.obs)
    np.testing.assert_array_equal(seqs.carries["critic"][1].numpy().reshape(32, -1),
                                  p.seq.carries["critic"][1])


# ------------------------------------------------------------- learn step
LEARN_CASES = {
    "k1": (1, {}),
    "k4": (4, {}),
    "k4_td3": (4, dict(twin_critic=True, target_policy_sigma=0.2)),
}


@pytest.mark.parametrize("case", sorted(LEARN_CASES))
def test_learn_step_matches_jax(case):
    """K learner steps on one pulled batch: the port's plain loop against
    the JAX learner's scan (``_learn_impl``), params converted from JAX,
    the smoothing normals JAX draws from ``fold_in(keys[k], 1)`` injected."""
    k_steps, knobs = LEARN_CASES[case]

    def config(base):
        return dataclasses.replace(
            base,
            agent=dataclasses.replace(base.agent, **knobs),
            trainer=dataclasses.replace(base.trainer, learner_steps=k_steps))

    jt = config(J_TINY).build()
    jl = JSamplerLearner(jt, JFleetConfig(num_actors=1), num_shards=1)
    pt = config(PENDULUM_TINY).build("cpu")
    pl = SamplerLearner(pt, FleetConfig(num_actors=1), num_shards=1)
    b = pt.config.batch_size
    rng = np.random.default_rng(7)
    j, p = _pair(rng, k_steps * b, provenance=False)
    probs = rng.uniform(1e-3, 2e-2, size=k_steps * b)  # float64, as pulled
    size = 123
    key = jax.random.PRNGKey(5)
    jtrain = jt.init().train
    host_train = jax.device_get(jtrain)
    jseq = jax.tree_util.tree_map(
        lambda x: np.reshape(x, (k_steps, b) + x.shape[1:]), j.seq)
    jprobs = np.reshape(probs.astype(np.float32), (k_steps, b))
    jtrain2, jprios, jm = jl._learn_impl(jtrain, jseq, jprobs, np.float32(size), key)
    normals = []
    acfg = pt.agent.config
    if acfg.target_policy_sigma > 0:
        shape = (acfg.unroll + acfg.n_step, b, p.seq.action.shape[-1])
        normals = [torch.tensor(np.asarray(jax.random.normal(jax.random.fold_in(k, 1), shape)))
                   for k in jax.random.split(key, k_steps)]
    draws = ReplayDraws(normals)
    seqs, pr = pl._place(p.seq, probs)
    ptrain, pprios, pm = pl._learn(train_state_from_jax(host_train, device="cpu"),
                                   seqs, pr, size, draws)
    assert draws.remaining() == 0
    assert pprios.shape == (k_steps, b)
    np.testing.assert_allclose(pprios.numpy(), np.asarray(jprios), **TOL)
    assert ptrain.step == int(jtrain2.step) == k_steps
    for name in PARAM_FIELDS:
        want = net_params_from_flax(getattr(jax.device_get(jtrain2), name))
        got = getattr(ptrain, name)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), **TOL,
                                       err_msg=f"{name}.{k}")
    assert set(pm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(pm[k]), float(jm[k]), **TOL, err_msg=k)


# ---------------------------------------------------------- ingest routing
def test_ingest_routes_seqs_into_shards_and_never_sheds():
    """SEQS go straight to the actor's shard (no staging queue), acks are
    always ok past a depth-1 queue, the ring caps at its capacity, and the
    accounting deltas land in the bank."""
    shards = ShardSet(2, 8, alpha=0.6)
    q = queue.Queue(maxsize=1)
    srv = IngestServer(q, address="127.0.0.1:0", shards=shards)
    srv.start()
    try:
        sock = transport.connect(srv.address)
        sock.settimeout(10)
        packer = wire.TreePacker(wire.WireConfig())
        send_frame(sock, K_HELLO, pack_hello(
            {"actor_id": 5, **wire.negotiation_fields(wire.WireConfig())}))
        recv_frame(sock)
        rng = np.random.default_rng(0)
        for phase in range(6):
            _, p = _pair(rng, 2)
            send_frame_parts(sock, K_SEQS, packer.pack({
                "phase": phase, "param_version": 0, "env_steps_delta": 8.0,
                "ep_return_sum": -1.0, "ep_count": 1.0, "staged": p}))
            kind, payload = recv_frame(sock)
            assert kind == K_ACK and unpack_obj(payload)["code"] == OK
        sock.close()
        assert srv.shed_total == 0 and q.qsize() == 0
        target = shards.route("5")
        assert target == j_shard_for_actor("5", 2)
        assert shards.shards[target].total_added == 12
        assert shards.shards[1 - target].total_added == 0
        assert shards.shards[target].occupancy() == 8
        assert shards.evictions_total() == 4
        assert shards.shards[target]._actor[0] == 5  # the HELLO identity
        stats = shards.pop_stats()
        assert stats["env_steps_delta"] == 48.0 and stats["ep_count"] == 6.0
        assert shards.pop_stats()["env_steps_delta"] == 0.0
    finally:
        srv.stop()


# ------------------------------------------------------------- learner e2e
def _swallow(fn):
    try:
        fn()
    except Exception:  # noqa: BLE001 - server teardown cuts the socket
        pass


def test_sampler_learner_end_to_end_thread_actor():
    """The port's actor in a thread streaming into a 2-shard sampler
    learner on the CPU: the exact step schedule, only sampled sequences
    cross the sampling boundary, priorities move, nothing sheds, and only
    the learner's thread runs the learner's modules."""
    trainer = PENDULUM_TINY.build("cpu")
    seen = set()
    for m in (trainer.agent.actor, trainer.agent.critic):
        for name in ("apply_params", "apply_seq"):  # both swap the parameters
            def apply(*args, _plain=getattr(m, name)):
                seen.add(threading.current_thread().name)
                return _plain(*args)

            setattr(m, name, apply)
    learner = SamplerLearner(trainer, FleetConfig(num_actors=1, idle_timeout_s=60),
                             num_shards=2)
    address = learner.start()
    actor = FleetActor(PENDULUM_TINY, actor_id=0, num_actors=1, address=address,
                       seed=0, device="cpu")
    th = threading.Thread(target=_swallow, args=(actor.run,), name="thread-actor",
                          daemon=True)
    th.start()
    logged = []
    try:
        state = learner.run(N_TRAIN, log_every=2,
                            metrics_fn=lambda p, s: logged.append((p, dict(s))))
    finally:
        learner.close()
        th.join(timeout=30)
    tc = trainer.config
    assert state.train.step == N_TRAIN * tc.learner_steps
    stats = learner.stats()
    assert stats["train_phases"] == N_TRAIN and stats["sheds"] == 0
    assert stats["trained_seqs"] == stats["trained_seqs_total"] == \
        N_TRAIN * tc.learner_steps * tc.batch_size
    assert stats["replay_occupancy"] >= tc.min_replay and stats["evictions"] >= 0
    # Every trained sequence crossed the sampling boundary once, in a frame.
    t = _template()
    per_seq = sum(x[0].nbytes for x in t["fields"].values()) + sum(
        x[0].nbytes for v in t["carries"].values() for x in v)
    assert stats["sample_bytes_total"] >= stats["trained_seqs"] * per_seq
    assert stats["bytes_per_trained_seq"] == pytest.approx(
        stats["sample_bytes_total"] / stats["trained_seqs"], rel=1e-3)
    assert stats["sample_p99_ms"] >= stats["sample_p50_ms"] > 0
    assert stats["prio_fetch_p50_ms"] >= 0 and stats["put_p50_ms"] >= 0
    assert [p for p, _ in logged] == [2, 4, 6]
    env_steps = [s["env_steps"] for _, s in logged]
    assert env_steps == sorted(env_steps) and env_steps[-1] > 0
    for _, s in logged:
        assert np.isfinite(s["critic_loss"]) and s["replay_occupancy"] > 0
    fed = learner.shards.shards[learner.shards.route(0)]
    assert fed.priority_sum() > 0 and fed._ever_sampled.any()
    assert seen == {threading.main_thread().name}


def test_sampler_learner_rejections():
    trainer = PENDULUM_TINY.build("cpu")
    for cfg, shards, match in (
        (FleetConfig(num_actors=0), 1, "num_actors"),
        (FleetConfig(num_actors=1), 0, "num_shards"),
        (FleetConfig(num_actors=1), 3, "divisible"),
        (FleetConfig(num_actors=1, drain_coalesce=2), 1, "drain"),
        (FleetConfig(num_actors=1, shard_pullers=-1), 1, "shard_pullers"),
    ):
        with pytest.raises(ValueError, match=match):
            SamplerLearner(trainer, cfg, num_shards=shards)


def test_health_fn_aborts_the_absorb():
    learner = SamplerLearner(PENDULUM_TINY.build("cpu"), FleetConfig(num_actors=1),
                             num_shards=1)
    learner.start()

    def health():
        raise RuntimeError("gave up actor(s) [0]")

    try:
        with pytest.raises(RuntimeError, match="gave up"):
            learner.run(1, health_fn=health)
    finally:
        learner.close()


# ------------------------------------------------------------ CLI refusals
def _jax_refusal(argv):
    from r2d2dpg_tpu import train as jtrain

    with pytest.raises(SystemExit) as e:
        jtrain.run(jtrain.parse_args(argv))
    return str(e.value)


def _port_refusal(argv):
    from r2d2dpg_torch.train import main

    with pytest.raises(SystemExit) as e:
        main([*argv, "--device", "cpu"])
    return str(e.value)


REFUSALS = {
    "shards_without_actors": (["--replay-shards", "2"], "requires --actors"),
    "shards_x_drain_coalesce": (["--actors", "2", "--replay-shards", "2",
                                 "--drain-coalesce", "4"], "does not compose"),
    "shard_procs_without_sampler": (["--shard-procs", "2"], "requires --actors"),
    "shard_procs_without_shards": (["--actors", "2", "--shard-procs", "2"],
                                   "requires --actors"),
    "pullers_without_shards": (["--shard-pullers", "2"], "require --replay-shards"),
    "prefetch_without_shards": (["--actors", "2", "--shard-prefetch", "1"],
                                "require --replay-shards"),
    "negative_shards": (["--actors", "2", "--replay-shards", "-1"], "must be >= 1"),
    "negative_shard_procs": (["--shard-procs", "-1"], "must be >= 0"),
    "shards_not_divisible_by_procs": (["--actors", "2", "--replay-shards", "3",
                                       "--shard-procs", "2"], "not divisible"),
    "negative_pullers": (["--actors", "2", "--replay-shards", "2",
                          "--shard-pullers", "-1"], "must be >= 0"),
    "capacity_not_divisible": (["--actors", "3", "--replay-shards", "3"],
                               "not divisible by 3 shards"),
    "min_replay_unreachable": (["--actors", "1", "--replay-shards", "2",
                                "--min-replay", "200"], "exceeds the reachable"),
}


@pytest.mark.parametrize("name", sorted(REFUSALS))
def test_cli_sampler_refusals_equal_jax(name):
    flags, match = REFUSALS[name]
    argv = ["--config", "pendulum_tiny", *flags]
    want = _jax_refusal(argv)
    assert re.search(match, want), want
    assert _port_refusal(argv) == want


def test_replay_shards_1_actors_0_bitwise_equals_trainer_run(capsys):
    """``--replay-shards 1 --actors 0`` (and the tier's off-settings)
    routes the untouched phase-locked loop: bitwise ``Trainer.run``."""
    from r2d2dpg_torch.train import main

    t = PENDULUM_TINY.build("cpu")
    ref = t.run(t.window_fill_phases + t.replay_fill_phases + N_TRAIN,
                log_every=2, log_fn=lambda *_: None)
    got = main(["--config", "pendulum_tiny", "--actors", "0", "--replay-shards", "1",
                "--shard-procs", "0", "--phases", str(N_TRAIN), "--log-every", "2",
                "--device", "cpu", "--watchdog", "0"])
    assert "phase-locked schedule runs unchanged" in capsys.readouterr().out
    _assert_states_bitwise(ref, got)


def test_train_cli_sampler_with_actor_subprocesses(tmp_path, capsys):
    """``train --actors 2 --replay-shards 2`` with real actor processes:
    the run's phases, the fleet line's sampler columns, checkpoints with
    the counter sidecar; the device arena shrunk to max(envs, batch)."""
    from r2d2dpg_torch.fleet import load_fleet_counters
    from r2d2dpg_torch.train import main

    state = main(["--config", "pendulum_tiny", "--actors", "2", "--replay-shards", "2",
                  "--phases", "3", "--device", "cpu", "--log-every", "1",
                  "--checkpoint-dir", str(tmp_path / "ck"), "--checkpoint-every", "2"])
    out = capsys.readouterr().out
    assert state.train.step == 3
    assert state.arena.priority.shape == (8,)  # max(num_envs 4, batch 8)
    assert "2 replay shards (learner-pulled sampling)" in out
    line = next(x for x in out.splitlines() if x.startswith("fleet: ") and "wall_s" in x)
    words = line.split()[1:]
    stats = dict(zip(words[::2], map(float, words[1::2])))
    assert stats["train_phases"] == 3 and stats["sheds"] == 0
    assert stats["trained_seqs_total"] == 3 * 8 and stats["sample_bytes_total"] > 0
    assert "evictions" in stats and "shard_restarts" not in stats
    assert len([x for x in out.splitlines() if x.startswith("phase ")]) == 3
    assert load_fleet_counters(str(tmp_path / "ck"), 2)["drained"] == 2.0
