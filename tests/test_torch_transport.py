"""Port parity: the fleet's framed transport (``r2d2dpg_torch/fleet/transport.py``).

Frames, multi-part sends, HELLO proofs and control payloads are compared
byte for byte with the JAX package's ``fleet/transport.py`` for the same
inputs; each refusal (truncated frame or header, CRC mismatch, declared
length past the ceiling, bad magic, malformed HELLO) raises the port's
error; the liveness protocol PINGs once and then reaps; ``to_host`` makes
owned numpy copies.  The wire lint (``scripts/lint_fleet_wire.sh``) runs,
unedited, over the port's fleet modules placed where it looks.  Exact
equality throughout: these are bytes.
"""

import os
import shutil
import socket
import struct
import subprocess
import threading

import numpy as np
import pytest
import torch

from r2d2dpg_tpu.fleet import transport as jt
from r2d2dpg_torch.fleet import transport as pt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.fleet

KINDS = [pt.K_HELLO, pt.K_SEQS, pt.K_ACK, pt.K_PARAMS, pt.K_BYE, pt.K_PING,
         pt.K_PONG]
PAYLOADS = [b"", b"x", bytes(range(256)) * 17]


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5)
    b.settimeout(5)
    return a, b


def _recv_all(sock, n):
    out = b""
    while len(out) < n:
        out += sock.recv(n - len(out))
    return out


def test_constants_equal_jax():
    for name in ("MAGIC", "HEADER_BYTES", "K_HELLO", "K_SEQS", "K_ACK",
                 "K_PARAMS", "K_BYE", "K_TELEM", "K_PING", "K_PONG",
                 "K_SAMPLE_REQ", "K_BATCH", "K_PRIO", "K_STATS",
                 "MAX_FRAME_BYTES", "SOCKET_BUF_BYTES", "READ_DEADLINE_S"):
        assert getattr(pt, name) == getattr(jt, name), name


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("payload", PAYLOADS, ids=["empty", "one", "big"])
def test_encode_frame_bytes_equal_jax(kind, payload):
    assert pt.encode_frame(kind, payload) == jt.encode_frame(kind, payload)


@pytest.mark.parametrize("mod", [pt, jt], ids=["port", "jax"])
def test_send_frame_and_parts_bytes_equal_jax(mod):
    """``send_frame`` and ``send_frame_parts`` put the JAX package's bytes
    on the wire, whichever package receives; byte counts returned."""
    payload = bytes(range(200)) * 50
    parts = [payload[:7], memoryview(payload[7:5000]), payload[5000:]]
    want = jt.encode_frame(pt.K_SEQS, payload)
    a, b = _pair()
    assert pt.send_frame(a, pt.K_SEQS, payload) == len(want)
    assert _recv_all(b, len(want)) == want
    assert pt.send_frame_parts(a, pt.K_SEQS, parts) == len(want)
    kind, got = mod.recv_frame(b)
    assert (kind, got) == (pt.K_SEQS, payload)
    a.close(), b.close()


def test_hello_proof_and_payloads_equal_jax():
    for token in ("s3cret", "", "été"):
        assert pt.hello_auth_proof(token) == jt.hello_auth_proof(token)
    hello = {"actor_id": 3, "num_envs": 4, "wire_version": 1,
             "encoding": "bf16", "compress": "zlib",
             "auth": pt.hello_auth_proof("s3cret")}
    assert pt.pack_hello(hello) == jt.pack_hello(hello)
    assert pt.unpack_hello(jt.pack_hello(hello)) == hello
    ack = {"code": "ok", "param_version": 7}
    assert pt.pack_obj(ack) == jt.pack_obj(ack)
    assert pt.unpack_obj(jt.pack_obj(ack)) == ack


@pytest.mark.parametrize("payload", [b"\xff\xfe", b"[1, 2]", b"nope", b"3"])
def test_malformed_hello_refused_as_jax(payload):
    with pytest.raises(jt.FrameError):
        jt.unpack_hello(payload)
    with pytest.raises(pt.FrameError, match="malformed HELLO"):
        pt.unpack_hello(payload)


def _truncated_frame(a):
    a.sendall(pt.encode_frame(pt.K_SEQS, b"x" * 64)[: pt.HEADER_BYTES + 10])
    a.close()


def _truncated_header(a):
    a.sendall(pt.encode_frame(pt.K_SEQS, b"")[: pt.HEADER_BYTES - 3])
    a.close()


def _crc(a):
    frame = bytearray(pt.encode_frame(pt.K_SEQS, b"hello world"))
    frame[-1] ^= 0xFF
    a.sendall(bytes(frame))


def _too_large(a):
    a.sendall(pt.encode_frame(pt.K_SEQS, b"x" * 100))


def _bad_magic(a):
    a.sendall(struct.Struct("!4sBQI").pack(b"NOPE", pt.K_SEQS, 0, 0))


@pytest.mark.parametrize("send, error", [
    (_truncated_frame, "FrameTruncated"),
    (_truncated_header, "FrameTruncated"),
    (_crc, "FrameCRCError"),
    (_too_large, "FrameTooLarge"),
    (_bad_magic, "FrameBadMagic"),
], ids=["truncated_frame", "truncated_header", "crc", "too_large", "bad_magic"])
def test_recv_frame_refusals_match_jax(send, error):
    for mod in (jt, pt):
        a, b = _pair()
        send(a)
        with pytest.raises(getattr(mod, error)):
            mod.recv_frame(b, max_frame_bytes=64)
        a.close(), b.close()
    assert issubclass(getattr(pt, error), pt.FrameError)


def test_oversized_send_refused_before_any_byte():
    a, b = _pair()
    with pytest.raises(pt.FrameTooLarge):
        pt.send_frame(a, pt.K_SEQS, b"x" * 100, max_frame_bytes=64)
    with pytest.raises(pt.FrameTooLarge):
        pt.send_frame_parts(a, pt.K_SEQS, [b"x" * 40, b"y" * 40], max_frame_bytes=64)
    with pytest.raises(pt.FrameTooLarge):
        pt.encode_frame(pt.K_SEQS, b"x" * (pt.MAX_FRAME_BYTES + 1))
    b.settimeout(0.05)
    with pytest.raises(socket.timeout):
        b.recv(1)
    a.close(), b.close()


def test_heartbeat_pings_once_then_reaps():
    """A silent peer: one deadline sends a PING, the second reaps."""
    a, b = _pair()
    b.settimeout(0.1)
    with pytest.raises(pt.PeerDeadError):
        pt.recv_frame_heartbeat(b)
    kind, payload = jt.recv_frame(a)
    assert (kind, payload) == (pt.K_PING, b"")
    a.settimeout(0.05)
    with pytest.raises(socket.timeout):
        a.recv(1)  # exactly one PING
    a.close(), b.close()


def test_heartbeat_answers_ping_and_returns_the_next_real_frame():
    a, b = _pair()
    seen_in, seen_out = [], []
    a.sendall(jt.encode_frame(pt.K_PING, b"") + jt.encode_frame(pt.K_PONG, b"")
              + jt.encode_frame(pt.K_ACK, b"done"))
    kind, payload = pt.recv_frame_heartbeat(
        b, bytes_in=seen_in.append, bytes_out=seen_out.append)
    assert (kind, payload) == (pt.K_ACK, b"done")
    assert jt.recv_frame(a) == (pt.K_PONG, b"")
    assert seen_in == [pt.HEADER_BYTES, pt.HEADER_BYTES]
    assert seen_out == [pt.HEADER_BYTES]
    a.close(), b.close()


def test_mid_frame_stall_is_a_reap_without_ping():
    a, b = _pair()
    a.sendall(pt.encode_frame(pt.K_SEQS, b"x" * 64)[: pt.HEADER_BYTES + 5])
    b.settimeout(0.1)
    with pytest.raises(pt.PeerDeadError, match="mid-frame"):
        pt.recv_frame_heartbeat(b)
    a.settimeout(0.05)
    with pytest.raises(socket.timeout):
        a.recv(1)  # no PING was sent
    a.close(), b.close()


@pytest.mark.parametrize("addr", [
    "127.0.0.1:7450", "unix:/tmp/x.sock", "localhost:1", "0.0.0.0:5",
    "10.0.0.1:80", "127.example.com:9", "[::1]:3", "host:port", "nonsense",
])
def test_address_helpers_equal_jax(addr):
    try:
        want = jt.parse_address(addr)
    except ValueError:
        with pytest.raises(ValueError, match="neither"):
            pt.parse_address(addr)
    else:
        assert pt.parse_address(addr) == want
    assert pt.is_loopback_address(addr) == jt.is_loopback_address(addr)


def test_connect_configures_the_socket():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    host, port = srv.getsockname()
    sock = pt.connect(f"{host}:{port}", read_deadline_s=7.0)
    try:
        assert sock.gettimeout() == 7.0
        assert sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
    finally:
        sock.close()
        srv.close()


def test_to_host_copies_a_tensor_tree():
    """Owned numpy leaves equal to the tensors, structure kept, numbers
    passed through, bf16 widened exactly; an in-place change of a source
    tensor afterwards leaves the snapshot as it was."""
    from r2d2dpg_torch.replay.arena import SequenceBatch

    w = torch.randn(3, 4)
    tree = {
        "net": {"w": w, "b": torch.arange(5, dtype=torch.int64)},
        "half": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
        "carry": (torch.ones(2, 3), torch.zeros(2, 3)),
        "seq": SequenceBatch(obs=torch.randn(2, 3, 1), action=torch.zeros(2, 3, 1),
                             reward=torch.ones(2, 3), discount=torch.ones(2, 3),
                             reset=torch.zeros(2, 3), carries={}),
        "step": 7,
        "none": None,
    }
    out = pt.to_host(tree)
    assert out["step"] == 7 and out["none"] is None
    assert isinstance(out["carry"], tuple)
    assert type(out["seq"]) is SequenceBatch
    np.testing.assert_array_equal(out["net"]["w"], w.numpy())
    assert out["net"]["b"].dtype == np.int64
    np.testing.assert_array_equal(out["half"], np.array([1.5, -2.0], np.float32))
    pairs = ((out["net"]["w"], tree["net"]["w"]), (out["net"]["b"], tree["net"]["b"]),
             (out["seq"].obs, tree["seq"].obs), (out["carry"][0], tree["carry"][0]))
    for leaf, src in pairs:
        assert isinstance(leaf, np.ndarray) and leaf.flags.aligned
        assert not np.shares_memory(leaf, src.numpy())
    before = out["net"]["w"].copy()
    w.add_(1.0)
    np.testing.assert_array_equal(out["net"]["w"], before)


def test_to_host_makes_one_device_to_host_copy(monkeypatch):
    """The whole tree crosses in one ``Tensor.cpu`` call."""
    calls = []
    plain = torch.Tensor.cpu

    def counting(self, *a, **k):
        calls.append(tuple(self.shape))
        return plain(self, *a, **k)

    monkeypatch.setattr(torch.Tensor, "cpu", counting)
    pt.to_host({"a": torch.ones(3), "b": [torch.zeros(2, 2), torch.ones(1)]})
    assert calls == [(4 * 3 + 4 * 4 + 4,)]


def _lint(tree):
    return subprocess.run(
        ["bash", str(tree / "scripts" / "lint_fleet_wire.sh")],
        capture_output=True, text=True,
    )


def test_lint_fleet_wire_passes_on_the_port(tmp_path):
    """``scripts/lint_fleet_wire.sh``, copied unedited, over the port's
    fleet modules placed where it scans: no pickle outside transport.py,
    control-frame pickles annotated, SEQS sent through send_frame_parts."""
    tree = tmp_path / "repo"
    (tree / "scripts").mkdir(parents=True)
    shutil.copy(os.path.join(REPO, "scripts", "lint_fleet_wire.sh"), tree / "scripts")
    shutil.copytree(os.path.join(REPO, "r2d2dpg_torch", "fleet"),
                    tree / "r2d2dpg_tpu" / "fleet",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _lint(tree)
    assert res.returncode == 0, res.stdout + res.stderr
    # And it would bite: a SEQS frame through the control sender fails it.
    (tree / "r2d2dpg_tpu" / "fleet" / "offender.py").write_text(
        "send_frame(sock, K_SEQS, payload)\n")
    res = _lint(tree)
    assert res.returncode == 1 and "offender.py" in res.stdout


def test_frames_cross_a_real_socket_between_threads():
    """A port sender and a JAX receiver on one TCP connection."""
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    host, port = srv.getsockname()
    got = []

    def serve():
        conn, _ = srv.accept()
        with conn:
            got.append(jt.recv_frame(conn))

    th = threading.Thread(target=serve)
    th.start()
    sock = pt.connect(f"{host}:{port}")
    pt.send_frame_parts(sock, pt.K_SEQS, [b"ab", b"cd"])
    th.join(timeout=10)
    sock.close()
    srv.close()
    assert got == [(pt.K_SEQS, b"abcd")]
