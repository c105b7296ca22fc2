"""Versioned length-prefixed wire protocol for the process fleet.

The port of the JAX package's ``swiftly_tpu/serve/ipc.py``: the same
header, frame types, checksum, deadlines and error taxonomy, so a frame
this module encodes is byte-equal to the JAX package's for the same
payload and each side decodes the other's. Payloads are plain Python and
numpy objects; a frame never carries a torch tensor (unpickling one in
the parent's reader thread would open a CUDA context there).

`serve.procfleet` runs each replica as a separate OS process; this
module is the only thing that crosses the boundary. The frame format
is deliberately boring — a fixed 16-byte header followed by a pickled
payload — because every interesting failure mode of a wire protocol is
in the *edges*, and those are pinned down here:

* **Versioned.** The header carries ``WIRE_VERSION``; a peer speaking
  a different version is rejected with `VersionMismatch` (fatal, not
  retried) instead of mis-parsing its frames.
* **Length-prefixed and bounded.** Payload length is declared up
  front and capped at ``MAX_FRAME_BYTES``; an oversized declaration is
  rejected (`FrameTooLarge`) before a single payload byte is read, so
  a corrupt length cannot make the reader allocate unboundedly or
  stall draining garbage.
* **Checksummed.** A CRC32 over the payload rejects torn or bit-
  flipped frames (`BadChecksum`) instead of unpickling garbage.
* **Never hangs.** Every socket read and write runs under a deadline
  (`sock.settimeout` re-armed per chunk with the *remaining* budget);
  expiry raises `WireDeadline`, which subclasses `TimeoutError` so the
  retry ladder (`resilience.retry.is_transient`) classifies it
  transient. A peer that dies mid-frame surfaces as `TruncatedFrame`
  (a `ConnectionError` — transient for connect-time retries, but a
  *stream* that truncates is unrecoverable: framing cannot resync, so
  callers drop the connection).

Error taxonomy (all under `WireError`):

====================  ==========================  =====================
error                 meaning                     retry classification
====================  ==========================  =====================
`WireDeadline`        deadline expired mid-read   transient (TimeoutError)
`TruncatedFrame`      peer closed mid-frame       transient (ConnectionError)
`BadMagic`            stream desynced / garbage   fatal
`BadChecksum`         payload corrupt             fatal
`FrameTooLarge`       length over the cap         fatal
`VersionMismatch`     peer speaks other version   fatal
====================  ==========================  =====================

Accounting (`obs.metrics`, zero-cost when disabled): ``ipc.frames_sent``
/ ``ipc.frames_received`` / ``ipc.bytes_sent`` / ``ipc.bytes_received``
volume counters, ``ipc.bad_frames`` (+ ``ipc.bad_frames.<reason>``),
``ipc.version_mismatches`` and ``ipc.deadline_expired``.

Payloads are pickled: both ends of the socket are this package's own
processes (the parent spawns the workers), never an untrusted peer.
"""

from __future__ import annotations

import pickle
import socket
import struct
import time
import zlib

from ..obs import metrics as _metrics

__all__ = [
    "FRAME_CONTROL",
    "FRAME_DRAIN",
    "FRAME_ERROR",
    "FRAME_HEARTBEAT",
    "FRAME_HELLO",
    "FRAME_REQUEST",
    "FRAME_RESULT",
    "FRAME_TELEMETRY",
    "HEADER_BYTES",
    "MAX_FRAME_BYTES",
    "WIRE_VERSION",
    "BadChecksum",
    "BadMagic",
    "FrameStream",
    "FrameTooLarge",
    "TruncatedFrame",
    "VersionMismatch",
    "WireDeadline",
    "WireError",
    "connect_unix",
    "recv_frame",
    "send_frame",
]

# Header: magic, version, frame type, flags, payload length, payload CRC32.
_MAGIC = b"SWFT"
_HEADER = struct.Struct("!4sHBBII")
HEADER_BYTES = _HEADER.size  # 16

WIRE_VERSION = 1

# A serve result is one subgrid row (~hundreds of KiB); 64 MiB is far
# above any legitimate frame and far below "allocate until the OOM
# killer arrives".
MAX_FRAME_BYTES = 64 * 1024 * 1024

FRAME_HELLO = 1
FRAME_REQUEST = 2
FRAME_RESULT = 3
FRAME_HEARTBEAT = 4
FRAME_DRAIN = 5
FRAME_ERROR = 6
FRAME_CONTROL = 7
FRAME_TELEMETRY = 8

_FRAME_TYPES = frozenset((
    FRAME_HELLO, FRAME_REQUEST, FRAME_RESULT, FRAME_HEARTBEAT,
    FRAME_DRAIN, FRAME_ERROR, FRAME_CONTROL, FRAME_TELEMETRY,
))


class WireError(Exception):
    """Base class for every structured wire failure."""


class WireDeadline(WireError, TimeoutError):
    """Deadline expired before the frame finished — transient."""


class TruncatedFrame(WireError, ConnectionError):
    """Peer closed the stream mid-frame."""


class BadMagic(WireError):
    """Stream desynced: header does not start with the magic."""


class BadChecksum(WireError):
    """Payload CRC mismatch — torn or corrupted frame."""


class FrameTooLarge(WireError):
    """Declared payload length exceeds ``MAX_FRAME_BYTES``."""


class VersionMismatch(WireError):
    """Peer speaks a different ``WIRE_VERSION``."""


def _bad(exc_cls, reason, detail):
    """Count and build a fatal frame rejection."""
    _metrics.count("ipc.bad_frames")
    _metrics.count(f"ipc.bad_frames.{reason}")
    if exc_cls is VersionMismatch:
        _metrics.count("ipc.version_mismatches")
    return exc_cls(detail)


_RECV_CHUNK = 256 * 1024


class FrameStream:
    """Stateful frame reader over one socket.

    A deadline that expires mid-frame must NOT desync the stream: the
    bytes already read are a frame prefix the next call has to resume
    from. This object keeps that partial buffer, so `recv_frame` can
    expire (`WireDeadline`, transient) any number of times and still
    hand over exactly the frames the peer sent. Use ONE `FrameStream`
    per connection for its whole life — constructing a second one
    abandons the first one's partial bytes.

    Fatal frame errors (`BadMagic`, `BadChecksum`, `FrameTooLarge`,
    `VersionMismatch`) leave the stream position undefined by nature —
    length-prefixed framing cannot resynchronise after corruption —
    so callers must drop the connection after any of them.
    """

    def __init__(self, sock):
        self.sock = sock
        self._buf = bytearray()

    def _fill(self, need, deadline_t, what):
        while len(self._buf) < need:
            remaining = deadline_t - time.monotonic()
            if remaining <= 0:
                _metrics.count("ipc.deadline_expired")
                raise WireDeadline(
                    f"wire read deadline expired with "
                    f"{len(self._buf)}/{need} bytes of {what}")
            self.sock.settimeout(remaining)
            try:
                chunk = self.sock.recv(_RECV_CHUNK)
            except socket.timeout:
                # spurious early wake (or exact expiry): loop back —
                # the remaining-budget check above judges the deadline
                continue
            except OSError as exc:
                raise TruncatedFrame(
                    f"socket failed with {len(self._buf)}/{need} bytes "
                    f"of {what}: {exc}") from exc
            if not chunk:
                raise TruncatedFrame(
                    f"peer closed with {len(self._buf)}/{need} bytes "
                    f"of {what}")
            self._buf += chunk

    def recv_frame(self, deadline_s=1.0):
        """Receive one frame; returns ``(frame_type, flags, payload)``.

        Every byte is read under the deadline; malformed frames raise
        the structured `WireError` subclasses documented in the module
        header — this call can fail, but it cannot hang and it cannot
        return garbage.
        """
        deadline_t = time.monotonic() + deadline_s
        self._fill(HEADER_BYTES, deadline_t, "header")
        magic, version, ftype, flags, length, crc = _HEADER.unpack(
            bytes(self._buf[:HEADER_BYTES]))
        if magic != _MAGIC:
            raise _bad(BadMagic, "magic", f"bad magic {magic!r}")
        if version != WIRE_VERSION:
            raise _bad(
                VersionMismatch, "version",
                f"peer wire version {version}, expected {WIRE_VERSION}")
        if ftype not in _FRAME_TYPES:
            raise _bad(BadMagic, "frame_type",
                       f"unknown frame type {ftype}")
        if length > MAX_FRAME_BYTES:
            raise _bad(
                FrameTooLarge, "oversized",
                f"declared payload {length} bytes > cap "
                f"{MAX_FRAME_BYTES}")
        self._fill(HEADER_BYTES + length, deadline_t, "payload")
        payload = bytes(self._buf[HEADER_BYTES:HEADER_BYTES + length])
        del self._buf[:HEADER_BYTES + length]
        if zlib.crc32(payload) != crc:
            raise _bad(BadChecksum, "checksum", "payload CRC mismatch")
        try:
            obj = pickle.loads(payload) if length else None
        except Exception as exc:
            raise _bad(BadChecksum, "payload",
                       f"payload undecodable: {exc}")
        _metrics.count("ipc.frames_received")
        _metrics.count("ipc.bytes_received", HEADER_BYTES + length)
        return ftype, flags, obj


def recv_frame(sock, deadline_s=1.0):
    """One-shot `FrameStream.recv_frame` for tests and short-lived
    connections. A long-lived connection MUST keep one `FrameStream`
    instead: this wrapper forgets partial bytes between calls."""
    return FrameStream(sock).recv_frame(deadline_s)


def encode_frame(ftype, payload_obj=None, flags=0, version=WIRE_VERSION):
    """Encode one frame to bytes (``version`` overridable for tests)."""
    payload = b"" if payload_obj is None else pickle.dumps(
        payload_obj, protocol=pickle.HIGHEST_PROTOCOL)
    if len(payload) > MAX_FRAME_BYTES:
        raise FrameTooLarge(
            f"payload {len(payload)} bytes > cap {MAX_FRAME_BYTES}")
    header = _HEADER.pack(
        _MAGIC, version, ftype, flags, len(payload), zlib.crc32(payload))
    return header + payload


def send_frame(sock, ftype, payload_obj=None, deadline_s=1.0, flags=0):
    """Send one frame, every byte under the deadline."""
    data = encode_frame(ftype, payload_obj, flags=flags)
    deadline_t = time.monotonic() + deadline_s
    sent = 0
    view = memoryview(data)
    while sent < len(data):
        remaining = deadline_t - time.monotonic()
        if remaining <= 0:
            _metrics.count("ipc.deadline_expired")
            raise WireDeadline(
                f"wire send deadline expired with "
                f"{len(data) - sent}/{len(data)} bytes left")
        sock.settimeout(remaining)
        try:
            sent += sock.send(view[sent:])
        except socket.timeout:
            continue  # remaining-budget check above judges the deadline
        except OSError as exc:
            raise TruncatedFrame(f"peer closed mid-send: {exc}") from exc
    _metrics.count("ipc.frames_sent")
    _metrics.count("ipc.bytes_sent", len(data))
    return len(data)


def connect_unix(path, deadline_s=5.0):
    """Connect to a unix socket, retrying while the peer boots.

    A worker that has not yet bound its socket surfaces as
    ``FileNotFoundError`` / ``ConnectionRefusedError`` — both OSErrors,
    both transient under `resilience.retry.is_transient` — so this
    loops the jittered-backoff ladder until the deadline.
    """
    from ..resilience.retry import backoff_delay

    deadline_t = time.monotonic() + deadline_s
    attempt = 0
    while True:
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(max(0.05, deadline_t - time.monotonic()))
            sock.connect(path)
            return sock
        except OSError:
            sock.close()
            if time.monotonic() >= deadline_t:
                raise
            time.sleep(min(backoff_delay(attempt, base_s=0.02, max_s=0.25),
                           max(0.0, deadline_t - time.monotonic())))
            attempt += 1
