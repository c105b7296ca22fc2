"""The port's wire protocol (``swiftly_tpu_torch.serve.ipc``) against the
JAX package's ``tests/test_ipc.py`` and the JAX package's own module.

The 18 cases of ``tests/test_ipc.py`` run against the port's module:
roundtrip of every frame type over a real socketpair, resume after a
deadline expiry without desync, structured rejection of truncated,
oversized, garbage, corrupt and version-mismatched frames, the retry
taxonomy (through the port's `resilience.retry.is_transient`) and the
``ipc.*`` counters. Then the two packages against each other, with byte
equality as the tolerance: for every frame type and the payloads the
process fleet sends (dicts, numpy rows in complex64 and float32,
``None``), the port's `encode_frame` gives the JAX package's bytes, and
each package's `FrameStream` decodes the other's frames over a
socketpair.
"""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from swiftly_tpu.serve import ipc as jipc
from swiftly_tpu_torch.models.config import SubgridConfig
from swiftly_tpu_torch.resilience.retry import is_transient
from swiftly_tpu_torch.serve import ipc
from swiftly_tpu_torch.serve.ipc import (
    FRAME_CONTROL,
    FRAME_DRAIN,
    FRAME_ERROR,
    FRAME_HEARTBEAT,
    FRAME_HELLO,
    FRAME_REQUEST,
    FRAME_RESULT,
    FRAME_TELEMETRY,
    HEADER_BYTES,
    MAX_FRAME_BYTES,
    WIRE_VERSION,
    BadChecksum,
    BadMagic,
    FrameStream,
    FrameTooLarge,
    TruncatedFrame,
    VersionMismatch,
    WireDeadline,
    WireError,
    encode_frame,
    recv_frame,
    send_frame,
)


@pytest.fixture
def pair():
    a, b = socket.socketpair()
    yield a, b
    a.close()
    b.close()


# ---------------------------------------------------------------------------
# roundtrip
# ---------------------------------------------------------------------------


def test_roundtrip_all_frame_types(pair):
    a, b = pair
    stream = FrameStream(b)
    payloads = {
        FRAME_HELLO: {"rid": 3, "pid": 1234},
        FRAME_REQUEST: {"req_id": 7, "config": (0, 1, 2)},
        FRAME_RESULT: {"req_id": 7, "rows": [b"\x00" * 64]},
        FRAME_HEARTBEAT: {"beat": 12, "depth": 0},
        FRAME_DRAIN: None,
        FRAME_ERROR: {"req_id": 7, "error": "boom"},
        FRAME_CONTROL: {"dwell_l2_s": 0.5},
    }
    for ftype, payload in payloads.items():
        send_frame(a, ftype, payload, deadline_s=5.0)
    for ftype, payload in payloads.items():
        got_type, got_flags, got = stream.recv_frame(deadline_s=5.0)
        assert got_type == ftype
        assert got_flags == 0
        assert got == payload


def test_roundtrip_flags_and_empty_payload(pair):
    a, b = pair
    send_frame(a, FRAME_DRAIN, None, deadline_s=5.0, flags=0x5A)
    ftype, flags, payload = recv_frame(b, deadline_s=5.0)
    assert (ftype, flags, payload) == (FRAME_DRAIN, 0x5A, None)


def test_header_is_sixteen_bytes():
    # the documented fixed-size header: magic(4) version(2) type(1)
    # flags(1) length(4) crc(4)
    assert HEADER_BYTES == 16
    frame = encode_frame(FRAME_DRAIN)
    assert len(frame) == HEADER_BYTES


# ---------------------------------------------------------------------------
# deadline expiry resumes without desync
# ---------------------------------------------------------------------------


def test_partial_frame_survives_deadline_expiry(pair):
    a, b = pair
    stream = FrameStream(b)
    frame = encode_frame(FRAME_REQUEST, {"req_id": 1, "blob": b"x" * 500})

    # deliver only a prefix: the read must expire transiently, not hang
    a.sendall(frame[:10])
    with pytest.raises(WireDeadline):
        stream.recv_frame(deadline_s=0.05)

    # a little more (past the header, into the payload): still expires
    a.sendall(frame[10:100])
    with pytest.raises(WireDeadline):
        stream.recv_frame(deadline_s=0.05)

    # the rest arrives: the SAME stream decodes the frame from its kept
    # prefix, and a second frame sent whole proves the stream is in sync
    a.sendall(frame[100:])
    ftype, _, payload = stream.recv_frame(deadline_s=5.0)
    assert ftype == FRAME_REQUEST
    assert payload == {"req_id": 1, "blob": b"x" * 500}

    send_frame(a, FRAME_HEARTBEAT, {"beat": 1}, deadline_s=5.0)
    ftype, _, payload = stream.recv_frame(deadline_s=5.0)
    assert (ftype, payload) == (FRAME_HEARTBEAT, {"beat": 1})


def test_dribbled_bytes_decode_across_expiries(pair):
    # worst case: the peer delivers one byte per deadline window; every
    # intermediate call expires, the final call returns the exact frame
    a, b = pair
    stream = FrameStream(b)
    frame = encode_frame(FRAME_HELLO, {"rid": 9})
    for i, byte in enumerate(frame):
        a.sendall(bytes([byte]))
        if i < len(frame) - 1:
            with pytest.raises(WireDeadline):
                stream.recv_frame(deadline_s=0.01)
    ftype, _, payload = stream.recv_frame(deadline_s=5.0)
    assert (ftype, payload) == (FRAME_HELLO, {"rid": 9})


def test_deadline_expiry_never_hangs(pair):
    # an idle peer: recv_frame must return (by raising) near the
    # deadline, not block forever
    _, b = pair
    t0 = time.monotonic()
    with pytest.raises(WireDeadline):
        FrameStream(b).recv_frame(deadline_s=0.1)
    assert time.monotonic() - t0 < 2.0


# ---------------------------------------------------------------------------
# structured rejection (fresh socketpair per case: fatal errors desync)
# ---------------------------------------------------------------------------


def _fresh_pair_with(data):
    a, b = socket.socketpair()
    a.sendall(data)
    a.close()  # peer gone: any missing bytes surface as truncation
    return b


def test_truncated_frame_peer_closed_mid_frame():
    frame = encode_frame(FRAME_RESULT, {"req_id": 1, "rows": [b"y" * 256]})
    b = _fresh_pair_with(frame[: HEADER_BYTES + 5])
    with pytest.raises(TruncatedFrame) as exc_info:
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()
    assert isinstance(exc_info.value, ConnectionError)


def test_truncated_header():
    b = _fresh_pair_with(b"SWFT\x00")
    with pytest.raises(TruncatedFrame):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()


def test_garbage_bytes_bad_magic():
    b = _fresh_pair_with(b"\xde\xad\xbe\xef" * 8)
    with pytest.raises(BadMagic):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()


def test_unknown_frame_type_rejected():
    header = ipc._HEADER.pack(b"SWFT", WIRE_VERSION, 250, 0, 0, 0)
    b = _fresh_pair_with(header)
    with pytest.raises(BadMagic):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()


def test_oversized_declared_length_rejected_before_payload():
    # a corrupt length field must be rejected from the header alone —
    # no payload bytes were even sent
    header = ipc._HEADER.pack(
        b"SWFT", WIRE_VERSION, FRAME_REQUEST, 0, MAX_FRAME_BYTES + 1, 0)
    b = _fresh_pair_with(header)
    t0 = time.monotonic()
    with pytest.raises(FrameTooLarge):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()
    assert time.monotonic() - t0 < 2.0


def test_version_mismatch_rejected():
    frame = encode_frame(FRAME_HELLO, {"rid": 0}, version=WIRE_VERSION + 1)
    b = _fresh_pair_with(frame)
    with pytest.raises(VersionMismatch):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()


def test_corrupt_payload_bad_checksum():
    frame = bytearray(encode_frame(FRAME_REQUEST, {"req_id": 42}))
    frame[-1] ^= 0xFF  # flip a payload bit; header CRC now disagrees
    b = _fresh_pair_with(bytes(frame))
    with pytest.raises(BadChecksum):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()


def test_encode_oversized_payload_rejected(monkeypatch):
    monkeypatch.setattr(ipc, "MAX_FRAME_BYTES", 256)
    with pytest.raises(FrameTooLarge):
        encode_frame(FRAME_RESULT, {"blob": b"z" * 1024})


# ---------------------------------------------------------------------------
# retry taxonomy
# ---------------------------------------------------------------------------


def test_error_taxonomy_and_transience():
    # transient: the retry ladder may re-try these
    assert issubclass(WireDeadline, TimeoutError)
    assert issubclass(TruncatedFrame, ConnectionError)
    assert is_transient(WireDeadline("deadline"))
    assert is_transient(TruncatedFrame("closed"))
    # fatal: deterministic frame rejections are NOT retried
    for exc in (BadMagic("m"), BadChecksum("c"),
                FrameTooLarge("f"), VersionMismatch("v")):
        assert isinstance(exc, WireError)
        assert not is_transient(exc)


def test_bad_frames_counted(monkeypatch):
    counted = []
    monkeypatch.setattr(
        ipc._metrics, "count", lambda name, n=1: counted.append(name))
    b = _fresh_pair_with(b"\x00" * HEADER_BYTES)
    with pytest.raises(BadMagic):
        FrameStream(b).recv_frame(deadline_s=5.0)
    b.close()
    assert "ipc.bad_frames" in counted
    assert "ipc.bad_frames.magic" in counted


def test_send_frame_counts_bytes(pair, monkeypatch):
    a, b = pair
    counted = {}
    monkeypatch.setattr(
        ipc._metrics, "count",
        lambda name, n=1: counted.__setitem__(
            name, counted.get(name, 0) + n))
    n = send_frame(a, FRAME_HEARTBEAT, {"beat": 0}, deadline_s=5.0)
    ftype, _, _ = FrameStream(b).recv_frame(deadline_s=5.0)
    assert ftype == FRAME_HEARTBEAT
    assert counted["ipc.frames_sent"] == 1
    assert counted["ipc.bytes_sent"] == n
    assert counted["ipc.frames_received"] == 1
    assert counted["ipc.bytes_received"] == n


def test_concurrent_sender_interleaves_cleanly(pair):
    # a writer thread streams many frames while the reader drains them
    # through one FrameStream: order and content survive
    a, b = pair
    n_frames = 200

    def write():
        for i in range(n_frames):
            send_frame(a, FRAME_RESULT, {"req_id": i}, deadline_s=10.0)

    t = threading.Thread(target=write)
    t.start()
    stream = FrameStream(b)
    for i in range(n_frames):
        ftype, _, payload = stream.recv_frame(deadline_s=10.0)
        assert ftype == FRAME_RESULT
        assert payload == {"req_id": i}
    t.join(10.0)
    assert not t.is_alive()


# ---------------------------------------------------------------------------
# the two packages against each other: byte equality
# ---------------------------------------------------------------------------


def test_constants_match_the_jax_package():
    assert ipc.HEADER_BYTES == jipc.HEADER_BYTES == 16
    assert ipc.WIRE_VERSION == jipc.WIRE_VERSION == 1
    assert ipc.MAX_FRAME_BYTES == jipc.MAX_FRAME_BYTES == 64 * 1024 * 1024
    assert ipc._MAGIC == jipc._MAGIC == b"SWFT"
    assert ipc._HEADER.format == jipc._HEADER.format
    for name in ("HELLO", "REQUEST", "RESULT", "HEARTBEAT", "DRAIN",
                 "ERROR", "CONTROL", "TELEMETRY"):
        assert getattr(ipc, f"FRAME_{name}") == getattr(jipc, f"FRAME_{name}")
    assert [getattr(ipc, f"FRAME_{n}") for n in (
        "HELLO", "REQUEST", "RESULT", "HEARTBEAT", "DRAIN", "ERROR",
        "CONTROL", "TELEMETRY")] == list(range(1, 9))


def _fleet_payloads():
    """(frame type, payload) pairs of the shapes the process fleet sends."""
    rng = np.random.default_rng(14)
    row_c64 = (rng.standard_normal((6, 6))
               + 1j * rng.standard_normal((6, 6))).astype(np.complex64)
    row_f32 = rng.standard_normal((6, 6, 2)).astype(np.float32)
    return [
        (FRAME_HELLO, {"fleet_pid": 4242, "t_epoch": 1234.5}),
        (FRAME_HELLO, {"rid": 1, "pid": 4243, "wire_version": 1,
                       "generation": 2, "t_epoch": 1234.75}),
        (FRAME_REQUEST, {"req_id": 7, "config": (0, 1, 2), "priority": 1,
                         "deadline_s": None,
                         "trace": {"id": 7, "span": 3, "pid": 4242}}),
        (FRAME_RESULT, {"req_id": 7, "status": "ok", "data": row_c64,
                        "error": None, "latency_s": 0.0125,
                        "path": "cache", "retries": 0,
                        "shed_reason": None, "retry_after_s": None}),
        (FRAME_RESULT, {"req_id": 8, "status": "ok", "data": row_f32,
                        "error": None, "latency_s": 0.5,
                        "path": "coalesced", "retries": 1,
                        "shed_reason": None, "retry_after_s": None}),
        (FRAME_RESULT, {"req_id": 9, "status": "shed", "data": None,
                        "error": "queue full", "latency_s": 0.0,
                        "path": None, "retries": 0,
                        "shed_reason": "depth", "retry_after_s": 0.05}),
        (FRAME_HEARTBEAT, {"rid": 0, "beats": 12, "served": 5,
                           "pending": 1}),
        (FRAME_TELEMETRY, {"rid": 0, "pid": 4243, "generation": 1,
                           "t_epoch": 1.5, "beats": 12, "served": 5,
                           "pending": 0,
                           "counters": {"proc.l2_rows_read": 3},
                           "stages": {"serve.batch": {"count": 2,
                                                      "total_s": 0.25}}}),
        (FRAME_CONTROL, {"dwell_l2_s": 1.5}),
        (FRAME_CONTROL, {"ack": True}),
        (FRAME_DRAIN, {}),
        (FRAME_DRAIN, None),
        (FRAME_ERROR, {"rid": 0, "error": "BadMagic('m')"}),
    ]


@pytest.mark.parametrize("case", range(len(_fleet_payloads())))
@pytest.mark.parametrize("flags", [0, 0x5A])
def test_frames_are_byte_equal_to_the_jax_package(case, flags):
    ftype, payload = _fleet_payloads()[case]
    port = encode_frame(ftype, payload, flags=flags)
    ref = jipc.encode_frame(ftype, payload, flags=flags)
    assert port == ref


def test_request_frame_with_a_subgrid_config_decodes_in_both():
    # the port's REQUEST payload carries the port's SubgridConfig; its
    # pickled bytes are the port's own, and both streams hand it back
    sg = SubgridConfig(256, 512, 228)
    frame = encode_frame(FRAME_REQUEST, {"req_id": 1, "config": sg})
    a, b = socket.socketpair()
    try:
        a.sendall(frame)
        ftype, _, got = jipc.FrameStream(b).recv_frame(deadline_s=5.0)
    finally:
        a.close()
        b.close()
    assert ftype == FRAME_REQUEST
    assert (got["config"].off0, got["config"].off1, got["config"].size) == (
        256, 512, 228)


def _assert_same(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_each_package_decodes_the_others_frames(direction):
    if direction == "port_to_jax":
        send, stream_cls = ipc.send_frame, jipc.FrameStream
    else:
        send, stream_cls = jipc.send_frame, ipc.FrameStream
    payloads = _fleet_payloads()
    a, b = socket.socketpair()
    try:
        stream = stream_cls(b)
        writer = threading.Thread(target=lambda: [
            send(a, ftype, payload, deadline_s=10.0, flags=i & 0xFF)
            for i, (ftype, payload) in enumerate(payloads)])
        writer.start()
        for i, (ftype, payload) in enumerate(payloads):
            got_type, got_flags, got = stream.recv_frame(deadline_s=10.0)
            assert (got_type, got_flags) == (ftype, i & 0xFF)
            _assert_same(got, payload)
        writer.join(10.0)
        assert not writer.is_alive()
    finally:
        a.close()
        b.close()


def test_jax_rejections_match_the_ports():
    # the same malformed bytes raise the same-named error in both
    bad = [
        (b"\xde\xad\xbe\xef" * 8, "BadMagic"),
        (encode_frame(FRAME_HELLO, {"rid": 0}, version=WIRE_VERSION + 1),
         "VersionMismatch"),
        (ipc._HEADER.pack(b"SWFT", WIRE_VERSION, FRAME_REQUEST, 0,
                          MAX_FRAME_BYTES + 1, 0), "FrameTooLarge"),
    ]
    corrupt = bytearray(encode_frame(FRAME_REQUEST, {"req_id": 42}))
    corrupt[-1] ^= 0xFF
    bad.append((bytes(corrupt), "BadChecksum"))
    for data, name in bad:
        for mod in (ipc, jipc):
            a, b = socket.socketpair()
            a.sendall(data)
            a.close()
            with pytest.raises(getattr(mod, name)):
                mod.FrameStream(b).recv_frame(deadline_s=5.0)
            b.close()


def test_connect_backoff_survives_a_long_boot():
    # a connect loop under a 240 s boot deadline runs past 1023 attempts;
    # the jittered delay must stay capped instead of overflowing a float
    from swiftly_tpu_torch.resilience.retry import backoff_delay

    for attempt in (0, 10, 1023, 1024, 5000):
        assert 0.0 < backoff_delay(attempt, base_s=0.02, max_s=0.25) <= 0.25
    # the capped exponent leaves every short ladder's delays as they were
    import random

    for attempt in range(12):
        a = backoff_delay(attempt, rng=random.Random(attempt))
        r = random.Random(attempt).random()
        assert a == min(2.0, 0.05 * (2.0 ** attempt)) * (0.5 + 0.5 * r)


def test_connect_unix_gives_up_at_its_deadline(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(OSError):
        ipc.connect_unix(str(tmp_path / "nobody.sock"), deadline_s=0.3)
    assert time.monotonic() - t0 < 3.0
