"""Port parity: the fleet's wire codec (``r2d2dpg_torch/fleet/wire.py``).

Every golden of ``tests/test_wire.py`` is reproduced byte for byte by the
port's packer, on the f32 and bf16 lanes, compressed and uncompressed, and
frames cross between the two packages in both directions (the port
decodes into its own ``StagedSequences``, the JAX package into its own).
The port has no bfloat16 numpy dtype: its bf16 bits equal the JAX codec's
on ties, signed zeros, infinities, NaNs and subnormals.  Every malformed,
bomb and schema case that the JAX unpacker refuses, the port refuses with
the same error class.  Exact equality throughout: these are bytes.
"""

import dataclasses
import json
import struct
import zlib

import numpy as np
import pytest

from r2d2dpg_tpu.fleet import wire as jw
from r2d2dpg_tpu.replay.arena import SequenceBatch as JSequenceBatch
from r2d2dpg_tpu.replay.arena import StagedSequences as JStaged
from r2d2dpg_torch.fleet import transport as pt
from r2d2dpg_torch.fleet import wire as pw
from r2d2dpg_torch.replay.arena import SequenceBatch, StagedSequences
from test_wire import _expected_payload, _msg, _sampler_handles, _staged

pytestmark = pytest.mark.fleet

_HDR = struct.Struct("!BBBBIQ")
LANES = [("f32", "none"), ("f32", "zlib"), ("bf16", "none"), ("bf16", "zlib")]
LANE_IDS = ["f32", "f32_zlib", "bf16", "bf16_zlib"]


def _port(staged):
    """A JAX ``StagedSequences`` of numpy leaves as the port's."""
    if staged is None:
        return None
    return StagedSequences(
        seq=SequenceBatch(**{f.name: getattr(staged.seq, f.name)
                             for f in dataclasses.fields(JSequenceBatch)}),
        priorities=staged.priorities,
        behavior_version=staged.behavior_version,
        collect_id=staged.collect_id,
    )


def _port_msg(msg):
    return {**msg, "staged": _port(msg["staged"])}


def _packs(obj_jax, obj_port, encoding="f32", compress="none", **kw):
    j = b"".join(jw.TreePacker(jw.WireConfig(encoding=encoding, compress=compress),
                               **kw).pack(obj_jax))
    p = b"".join(pw.TreePacker(pw.WireConfig(encoding=encoding, compress=compress),
                               **kw).pack(obj_port))
    return j, p


def _assert_staged_equal(got, want):
    for f in ("obs", "action", "reward", "discount", "reset"):
        g, w = getattr(got.seq, f), getattr(want.seq, f)
        assert np.asarray(g).dtype == np.asarray(w).dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    for k in want.seq.carries:
        np.testing.assert_array_equal(got.seq.carries[k], want.seq.carries[k])
    for f in ("priorities", "behavior_version", "collect_id"):
        g, w = getattr(got, f), getattr(want, f)
        assert (g is None) == (w is None), f
        if w is not None:
            np.testing.assert_array_equal(g, w, err_msg=f)


def test_sequence_batch_field_order_equals_jax():
    """The SEQS schema walks the batch's fields in order, so the same
    staged batch gives the same bytes from either package only if the
    fields are the same, in the same order."""
    assert ([f.name for f in dataclasses.fields(SequenceBatch)]
            == [f.name for f in dataclasses.fields(JSequenceBatch)])
    assert ([f.name for f in dataclasses.fields(StagedSequences)]
            == [f.name for f in dataclasses.fields(JStaged)])


def test_constants_equal_jax():
    for name in ("WIRE_VERSION", "ENCODINGS", "COMPRESSIONS", "F32_PINNED_LEAVES",
                 "HEADER_BYTES", "_SCHEMA_CACHE_MAX", "_VIEW_MIN_BYTES"):
        assert getattr(pw, name) == getattr(jw, name), name
    assert pw.available_compressions() == jw.available_compressions()
    assert issubclass(pw.WireFormatError, pt.FrameError)


# ------------------------------------------------------------ golden bytes
@pytest.mark.parametrize("encoding, compress", LANES, ids=LANE_IDS)
@pytest.mark.parametrize("provenance", [False, True], ids=["plain", "provenance"])
def test_golden_bytes_equal_jax(encoding, compress, provenance):
    msg = _msg(_staged(provenance=provenance))
    j, p = _packs(msg, _port_msg(msg), encoding, compress)
    assert p == j
    if compress == "none":
        assert p == _expected_payload(msg, encoding)


@pytest.mark.parametrize("encoding, compress", LANES, ids=LANE_IDS)
@pytest.mark.parametrize("provenance", [False, True], ids=["plain", "provenance"])
def test_frames_cross_both_ways(encoding, compress, provenance):
    """The port decodes JAX frames into its own dataclasses and the JAX
    package decodes the port's, leaf for leaf what each decodes itself."""
    msg = _msg(_staged(provenance=provenance))
    j, p = _packs(msg, _port_msg(msg), encoding, compress)
    mine = pw.TreeUnpacker().unpack(j)
    theirs = jw.TreeUnpacker().unpack(p)
    ref = jw.TreeUnpacker().unpack(j)
    assert type(mine["staged"]) is StagedSequences
    assert type(mine["staged"].seq) is SequenceBatch
    assert type(theirs["staged"]) is JStaged
    for k in ("phase", "param_version", "env_steps_delta", "ep_return_sum", "ep_count"):
        assert mine[k] == theirs[k] == ref[k] and type(mine[k]) is type(ref[k])
    _assert_staged_equal(mine["staged"], ref["staged"])
    _assert_staged_equal(theirs["staged"], ref["staged"])


@pytest.mark.parametrize("encoding", ["f32", "bf16"])
def test_compressed_body_is_the_uncompressed_body_through_zlib(encoding):
    msg = _port_msg(_msg(_staged()))
    plain = b"".join(pw.TreePacker(pw.WireConfig(encoding=encoding)).pack(msg))
    comp = b"".join(pw.TreePacker(
        pw.WireConfig(encoding=encoding, compress="zlib")).pack(msg))
    (slen,) = struct.unpack_from("!I", plain, _HDR.size)
    body_off = _HDR.size + 4 + slen
    assert plain[4:_HDR.size] == comp[4:_HDR.size]
    assert zlib.decompress(comp[body_off:]) == plain[body_off:]
    assert len(comp) < len(plain)


# ------------------------------------------------------------ bf16 lane
SPECIAL_BITS = np.array([
    0x00000000, 0x80000000,  # +-0
    0x7F800000, 0xFF800000,  # +-inf
    0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001, 0x7FBFFFFF, 0x7FFFFFFF,
    0xFFFFFFFF, 0x7FA00000,  # NaNs: quiet, signalling, payloads, both signs
    0x00000001, 0x80000001, 0x00007FFF, 0x00008000, 0x00018000, 0x007FFFFF,
    0x00400000, 0x807F8000,  # subnormals, and ties among them
    0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,  # ties to even, near ties
    0x7F7FFFFF, 0x7F7F8000, 0x7F7F7FFF, 0xFF7F8000,  # overflow to inf at a tie
    0x3F800000, 0xBF800000, 0x00800000, 0x80800000,  # normal edges
], np.uint32)


@pytest.mark.parametrize("which", ["specials", "random"])
def test_bf16_bits_equal_the_jax_codec(which):
    if which == "specials":
        x = SPECIAL_BITS.view(np.float32)
    else:
        bits = np.random.default_rng(3).integers(0, 2**32, size=200_000,
                                                 dtype=np.uint64)
        x = bits.astype(np.uint32).view(np.float32)
    # Above and below the zero-copy threshold: both branches of _leaf_part.
    for arr in (x, x[:5]):
        j, p = _packs({"w": arr}, {"w": arr}, "bf16")
        assert p == j
        got = pw.TreeUnpacker().unpack(j)["w"]
        ref = jw.TreeUnpacker().unpack(j)["w"]
        assert got.dtype == ref.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_bf16_conversion_helpers_round_trip():
    x = SPECIAL_BITS.view(np.float32)
    bits = pw.f32_to_bf16_bits(x)
    assert bits.dtype == np.uint16
    back = pw.bf16_bits_to_f32(bits)
    # Non-NaN values of one bf16 pattern come back exactly.
    again = pw.f32_to_bf16_bits(back)
    np.testing.assert_array_equal(again, bits)


def test_bf16_restoration_dtype_and_error_bounds():
    """The JAX test's bounds on the port: float32 back within bf16's 8-bit
    mantissa; pinned leaves (reward, discount, priorities) exact."""
    msg = _port_msg(_msg(_staged()))
    out = pw.TreeUnpacker().unpack(
        b"".join(pw.TreePacker(pw.WireConfig(encoding="bf16")).pack(msg)))
    got, want = out["staged"], msg["staged"]
    for name in ("obs", "action"):
        g, w = getattr(got.seq, name), getattr(want.seq, name)
        assert g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=2**-8, atol=0)
        assert not np.array_equal(g, w)
    for name in ("reward", "discount", "reset"):
        np.testing.assert_array_equal(getattr(got.seq, name), getattr(want.seq, name))
    np.testing.assert_array_equal(got.priorities, want.priorities)


def test_bfloat16_storage_from_jax_decodes_widened():
    """A JAX leaf stored as bfloat16 (no numpy dtype in the port) decodes
    as float32 with the same values."""
    import ml_dtypes

    arr = np.array([1.5, -0.0, np.inf, 3.0e-39], np.float32).astype(ml_dtypes.bfloat16)
    j = b"".join(jw.TreePacker(jw.WireConfig()).pack({"h": arr}))
    got = pw.TreeUnpacker().unpack(j)["h"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, arr.astype(np.float32))


@pytest.mark.parametrize("encoding", ["f32", "bf16"])
def test_large_arrays_take_the_memoryview_path(encoding):
    big = np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32)
    parts = pw.TreePacker(pw.WireConfig(encoding=encoding)).pack({"w": big})
    assert any(isinstance(p, memoryview) for p in parts)
    out = pw.TreeUnpacker().unpack(b"".join(bytes(p) for p in parts))
    assert out["w"].dtype == np.float32
    np.testing.assert_allclose(out["w"], big, rtol=0 if encoding == "f32" else 2**-8)


# ------------------------------------------------------------ round trips
def test_decode_is_zero_copy_views_on_f32_wire():
    payload = b"".join(pw.TreePacker(pw.WireConfig()).pack(_port_msg(_msg(_staged()))))
    v = pw.TreeUnpacker().unpack(payload)["staged"].seq.obs
    assert v.base is not None and not v.flags.writeable


def test_none_priorities_scalar_arrays_and_leafless_trees():
    msg = {"staged": _port(_staged(priorities=False)),
           "step": np.asarray(17, np.int32), "flag": True, "note": None}
    out = pw.TreeUnpacker().unpack(
        b"".join(pw.TreePacker(pw.WireConfig(encoding="bf16")).pack(msg)))
    assert out["staged"].priorities is None
    assert out["step"] == 17 and out["step"].dtype == np.int32
    assert out["flag"] is True and out["note"] is None
    packer = pw.TreePacker(pw.WireConfig(compress="zlib"))
    assert pw.TreeUnpacker().unpack(b"".join(packer.pack({"note": None}))) == {"note": None}


def test_schema_cached_after_first_frame():
    msg = _port_msg(_msg(_staged()))
    packer, unpacker = pw.TreePacker(pw.WireConfig()), pw.TreeUnpacker()
    first, steady = b"".join(packer.pack(msg)), b"".join(packer.pack(msg))
    assert len(steady) < len(first)
    unpacker.unpack(first)
    unpacker.unpack(steady)
    with pytest.raises(pw.WireFormatError, match="unknown schema id"):
        pw.TreeUnpacker().unpack(steady)
    bcast = pw.TreePacker(pw.WireConfig(), always_inline=True)
    b1, b2 = b"".join(bcast.pack(msg)), b"".join(bcast.pack(msg))
    assert b1 == b2
    pw.TreeUnpacker().unpack(b2)


@pytest.mark.parametrize("case", ["bounded", "sender_forgets", "reinline", "hot"])
def test_schema_cache_coherence(case):
    cap = pw._SCHEMA_CACHE_MAX
    u = pw.TreeUnpacker()
    if case == "bounded":
        p = pw.TreePacker(pw.WireConfig(), always_inline=True)
        for i in range(cap + 16):
            u.unpack(b"".join(p.pack({f"k{i}": float(i)})))
        assert len(u._schemas) <= cap
    elif case == "sender_forgets":
        p = pw.TreePacker(pw.WireConfig())
        u.unpack(b"".join(p.pack({"k0": 0.0})))
        for i in range(1, cap + 8):
            u.unpack(b"".join(p.pack({f"k{i}": float(i)})))
        assert u.unpack(b"".join(p.pack({"k0": 0.0}))) == {"k0": 0.0}
    elif case == "reinline":
        p = pw.TreePacker(pw.WireConfig(), always_inline=True)
        u.unpack(b"".join(p.pack({"k0": 0.0})))
        for i in range(1, cap - 1):
            u.unpack(b"".join(p.pack({f"k{i}": float(i)})))
        u.unpack(b"".join(p.pack({"k0": 0.0})))
        for i in range(cap, cap + 8):
            u.unpack(b"".join(p.pack({f"k{i}": float(i)})))
        sjson = json.dumps({"d": [["k0", "f"]]}, separators=(",", ":")).encode()
        assert zlib.crc32(sjson) in u._schemas
    else:
        p = pw.TreePacker(pw.WireConfig())
        u.unpack(b"".join(p.pack({"k0": 0.0})))
        for i in range(1, cap + 8):
            u.unpack(b"".join(p.pack({f"k{i}": float(i)})))
            assert u.unpack(b"".join(p.pack({"k0": 0.0}))) == {"k0": 0.0}


# ------------------------------------------------------------- refusals
def _craft(schema_obj, body=b"", comp=0, raw_len=None):
    sjson = json.dumps(schema_obj, separators=(",", ":")).encode()
    return (_HDR.pack(1, comp, 1, 0, zlib.crc32(sjson),
                      len(body) if raw_len is None else raw_len)
            + struct.pack("!I", len(sjson)) + sjson + body)


def _good(compress="none"):
    return b"".join(jw.TreePacker(jw.WireConfig(compress=compress)).pack(_msg(_staged())))


def _flip(data, i, value=None):
    b = bytearray(data)
    b[i] = value if value is not None else b[i] ^ 0xFF
    return bytes(b)


def _lie(delta):
    g = _good("zlib")
    _, comp, flags, _, sid, raw_len = _HDR.unpack_from(g, 0)
    return _HDR.pack(1, comp, flags, 0, sid, raw_len + delta) + g[_HDR.size:]


def _nested(depth=40_000):
    sjson = (b'{"l":[' * depth) + b'"n"' + (b"]}" * depth)
    return _HDR.pack(1, 0, 1, 0, zlib.crc32(sjson), 0) + struct.pack("!I", len(sjson)) + sjson


MALFORMED = {
    "truncated_body": lambda: _good()[:-16],
    "shorter_than_header": lambda: _good()[:8],
    "bad_version": lambda: _flip(_good(), 0, 99),
    "bad_compression_code": lambda: _flip(_good(), 1, 7),
    "schema_bit_flip": lambda: _flip(_good(), _HDR.size + 4 + 2),
    "unknown_schema_id": lambda: b"\x01" + b"\x00" * 15,
    "object_dtype": lambda: _craft({"a": ["object", "object", [1]]}, b"x" * 8),
    "negative_shape": lambda: _craft({"a": ["float32", "float32", [-4]]}),
    "nonsense_node": lambda: _craft({"zzz": []}),
    "under_consumed": lambda: _craft("n", b"\x00" * 8),
    "dict_not_list": lambda: _craft({"d": 5}),
    "dict_key_not_str": lambda: _craft({"d": [[[], "n"]]}),
    "dict_entry_arity": lambda: _craft({"d": [["k"]]}),
    "staged_not_list": lambda: _craft({"S": "nope"}),
    "bf16_storage_wrong_wire": lambda: _craft(
        {"a": ["bfloat16", "float32", [1]]}, b"\x00" * 4),
    "declared_past_ceiling": lambda: _craft('n', zlib.compress(b"\x00" * 1024),
                                            comp=1, raw_len=1 << 40),
    "zero_declared_zlib": lambda: _craft('n', zlib.compress(b"\x00" * (1 << 20), 9),
                                         comp=1, raw_len=0),
    "length_lie_short": lambda: _lie(-8),
    "length_lie_long": lambda: _lie(8),
    "trailing_garbage": lambda: _good("zlib") + b"GARBAGE",
    "absurd_declared_length": lambda: b"\x01\x00" * 10,
    "pathological_nesting": _nested,
}


@pytest.mark.parametrize("case", sorted(MALFORMED))
def test_port_refuses_what_jax_refuses(case):
    payload = MALFORMED[case]()
    kw = {"max_frame_bytes": 1 << 20}
    try:
        jw.TreeUnpacker(**kw).unpack(payload)
    except jw.FrameError as e:
        want = type(e).__name__
    else:  # only the port-specific case: JAX has the dtype and decodes it
        assert case == "bf16_storage_wrong_wire"
        want = "WireFormatError"
    with pytest.raises(pt.FrameError) as got:
        pw.TreeUnpacker(**kw).unpack(payload)
    assert type(got.value).__name__ == want


@pytest.mark.parametrize("obj, match", [
    ({"bad": object()}, "unsupported"),
    ({"w": np.arange(4.0, dtype=np.dtype(">f4"))}, "big-endian"),
    ({1: np.zeros(2)}, "non-string dict key"),
    ({"o": np.array([None])}, "object-dtype"),
], ids=["object", "big_endian", "int_key", "object_array"])
def test_pack_refusals_equal_jax(obj, match):
    with pytest.raises(jw.WireFormatError, match=match):
        jw.TreePacker(jw.WireConfig()).pack(obj)
    with pytest.raises(pw.WireFormatError, match=match):
        pw.TreePacker(pw.WireConfig()).pack(obj)


def test_oversized_body_refused_at_pack():
    with pytest.raises(pt.FrameTooLarge):
        pw.TreePacker(pw.WireConfig(), max_frame_bytes=64).pack({"w": np.zeros(32)})


# ------------------------------------------------------------ negotiation
@pytest.mark.parametrize("hello", [
    {}, {"wire_version": 1}, {"wire_version": 2, "encoding": "bf16", "compress": "zlib"},
    {"wire_version": 1, "encoding": "f32", "compress": "zlib"},
    {"wire_version": 1, "encoding": "bf16", "compress": "none"},
    {"wire_version": 1, "encoding": "bf16", "compress": "zlib"},
], ids=["empty", "version_only", "version_2", "encoding", "compress", "match"])
def test_negotiation_equals_jax(hello):
    cfg_j = jw.WireConfig(encoding="bf16", compress="zlib")
    cfg_p = pw.WireConfig(encoding="bf16", compress="zlib")
    assert pw.negotiation_fields(cfg_p) == jw.negotiation_fields(cfg_j)
    assert pw.check_negotiation(hello, cfg_p) == jw.check_negotiation(hello, cfg_j)


@pytest.mark.parametrize("kw, match", [
    ({"encoding": "f16"}, "encoding"), ({"compress": "lz4"}, "compression"),
])
def test_wire_config_refusals(kw, match):
    with pytest.raises(ValueError, match=match):
        pw.WireConfig(**kw).validate()


def test_zstd_gated_on_module_availability():
    cfg = pw.WireConfig(compress="zstd")
    if "zstd" in pw.available_compressions():
        cfg.validate()
        msg = _msg(_staged())
        j, p = _packs(msg, _port_msg(msg), "bf16", "zstd")
        _assert_staged_equal(pw.TreeUnpacker().unpack(j)["staged"],
                             jw.TreeUnpacker().unpack(j)["staged"])
        _assert_staged_equal(jw.TreeUnpacker().unpack(p)["staged"],
                             jw.TreeUnpacker().unpack(j)["staged"])
    else:
        with pytest.raises(ValueError, match="not available"):
            cfg.validate()


# --------------------------------------------------------- sampler frames
def test_sampler_frames_bytes_equal_jax():
    slots, gens, probs = _sampler_handles()
    prios = np.array([0.5, 2.0, 8.0], np.float32)
    for j_fn, p_fn, kw in (
        (jw.pack_sample_req, pw.pack_sample_req, dict(req_id=7, shard=2, quota=16)),
        (jw.pack_prio_update, pw.pack_prio_update,
         dict(shard=1, slots=slots, gens=gens, priorities=prios, epoch=4)),
    ):
        j = b"".join(j_fn(jw.TreePacker(jw.WireConfig()), **kw))
        p = b"".join(p_fn(pw.TreePacker(pw.WireConfig()), **kw))
        assert p == j
    req = b"".join(pw.pack_sample_req(
        pw.TreePacker(pw.WireConfig()), req_id=7, shard=2, quota=16))
    assert pw.unpack_sample_req(pw.TreeUnpacker().unpack(req)) == {
        "req_id": 7, "shard": 2, "quota": 16}


def test_coalesce_prio_update_equals_jax():
    slots = np.array([1, 2, 1, 3, 1], np.int64)
    gens = np.array([1, 1, 1, 1, 2], np.int64)
    prios = np.array([9.0, 8.0, 7.0, 6.0, 0.5], np.float32)
    for got, want in zip(pw.coalesce_prio_update(slots, gens, prios),
                         jw.coalesce_prio_update(slots, gens, prios)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    with pytest.raises(pw.WireFormatError):
        pw.coalesce_prio_update(slots, gens[:3], prios)


@pytest.mark.parametrize("encoding", ["f32", "bf16"])
@pytest.mark.parametrize("provenance", [False, True], ids=["plain", "provenance"])
def test_shard_batch_bytes_equal_jax(encoding, provenance):
    slots, gens, probs = _sampler_handles()
    staged = _staged(b=3, priorities=False)
    prov = (dict(behavior=np.array([4, -1, 6], np.int64),
                 collect=np.array([1, 2, 3], np.int64),
                 actors=np.array([0, 1, -1], np.int64)) if provenance else {})
    kw = dict(req_id=9, shard=1, slots=slots, gens=gens, probs=probs,
              priority_sum=12.5, occupancy=3, epoch=2, **prov)
    j = b"".join(jw.pack_shard_batch(
        jw.TreePacker(jw.WireConfig(encoding=encoding)), staged=staged, **kw))
    p = b"".join(pw.pack_shard_batch(
        pw.TreePacker(pw.WireConfig(encoding=encoding)), staged=_port(staged), **kw))
    assert p == j
    out = pw.unpack_shard_batch(pw.TreeUnpacker().unpack(j))
    assert type(out["staged"]) is StagedSequences
    np.testing.assert_array_equal(out["probs"], probs)
    assert out["probs"].dtype == np.float64


def _batch_payload(**over):
    slots, gens, probs = _sampler_handles()
    obj = {"req_id": 1, "shard": 0, "epoch": 0, "priority_sum": 1.0,
           "occupancy": 3, "staged": _port(_staged(b=3, priorities=False)),
           "slots": slots, "gens": gens, "probs": probs}
    obj.update(over)
    return {k: v for k, v in obj.items() if v is not None}


SAMPLER_REFUSALS = {
    "req_missing_quota": (pw.unpack_sample_req, {"req_id": 1, "shard": 0}, "SAMPLE_REQ"),
    "req_negative_quota": (pw.unpack_sample_req,
                           {"req_id": 1, "shard": 0, "quota": -1}, "quota"),
    "req_negative_shard": (pw.unpack_sample_req,
                           {"req_id": 1, "shard": -1, "quota": 2}, ">= 0"),
    "batch_missing": (pw.unpack_shard_batch, {"req_id": 1}, "malformed BATCH"),
    "batch_length": (pw.unpack_shard_batch,
                     _batch_payload(staged=_port(_staged(b=2, priorities=False))),
                     "length mismatch"),
    "batch_negative_slot": (pw.unpack_shard_batch,
                            _batch_payload(slots=np.array([0, -2, 1], np.int64)), ">= 0"),
    "batch_no_advert": (pw.unpack_shard_batch,
                        _batch_payload(priority_sum=None, occupancy=None),
                        "malformed BATCH"),
    "batch_partial_triple": (pw.unpack_shard_batch,
                             _batch_payload(behavior=np.zeros(3, np.int64)),
                             "provenance triple"),
    "batch_below_sentinel": (pw.unpack_shard_batch, _batch_payload(
        behavior=np.array([4, -2, 6], np.int64), collect=np.zeros(3, np.int64),
        actors=np.zeros(3, np.int64)), "below the -1 sentinel"),
    "prio_missing": (pw.unpack_prio_update, {"shard": 0, "slots": np.zeros(3, np.int64)},
                     "malformed PRIO"),
    "prio_length": (pw.unpack_prio_update, {
        "shard": 0, "epoch": 0, "slots": np.zeros(3, np.int64),
        "gens": np.zeros(2, np.int64), "priorities": np.ones(3, np.float32)},
        "length mismatch"),
    "prio_negative_slot": (pw.unpack_prio_update, {
        "shard": 0, "epoch": 0, "slots": np.array([-1, 0, 1], np.int64),
        "gens": np.zeros(3, np.int64), "priorities": np.ones(3, np.float32)}, ">= 0"),
}


@pytest.mark.parametrize("case", sorted(SAMPLER_REFUSALS))
def test_sampler_validators_refuse_malformed(case):
    fn, obj, match = SAMPLER_REFUSALS[case]
    with pytest.raises(pw.WireFormatError, match=match):
        fn(obj)


def test_partial_batch_provenance_refused_at_pack():
    slots, gens, probs = _sampler_handles()
    with pytest.raises(pw.WireFormatError, match="all-present or all-absent"):
        pw.pack_shard_batch(
            pw.TreePacker(pw.WireConfig()), req_id=1, shard=0,
            staged=_port(_staged(b=3, priorities=False)), slots=slots, gens=gens,
            probs=probs, priority_sum=1.0, occupancy=3,
            behavior=np.zeros(3, np.int64))
