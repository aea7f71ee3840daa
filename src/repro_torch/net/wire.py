"""Length-prefixed binary wire protocol, v3: segmented tagged frames
(DESIGN.md §3.1).

Frame format, lowest layer of the transport::

    +----------------+--------------------------------------------------+
    | length: u32 BE | payload: `length` bytes                          |
    +----------------+--------------------------------------------------+

    payload := [nbufs: u8] [pick_len: u32 BE] ([buf_len: u32 BE])*nbufs
               [pickle bytes] ([buffer bytes])*nbufs

The pickle is protocol 5 with **out-of-band buffers**: bulk byte payloads
(piggybacked read-buffer and held-state copies) travel as raw trailing
segments instead of being re-copied into the pickle stream — senders wrap
them with :func:`oob` and the codec is otherwise transparent (receivers
get plain ``bytes`` back). Senders transmit the segment list with one
vectored ``sendmsg`` (:func:`send_msg` / :func:`send_frames`), so neither
the header nor the payload is ever concatenated into a fresh buffer.

One multiplexed connection carries many concurrent conversations, so
messages are *tagged* with a request id:

* client → server: ``(req_id, op, kwargs)`` — an RPC invocation. A
  ``req_id`` of ``None`` marks a **one-way** message: the server executes
  the op, sends no reply, and reports failures (if any) as an
  ``oneway_err`` note on the same connection (error deferral — the client
  surfaces it at the transaction's next sync point).
* server → client: ``(req_id, status, value, notes)`` — the reply to the
  request tagged ``req_id``; ``status`` is ``OK`` or ``ERR``. When
  ``req_id`` is ``None`` the message is an unsolicited **push** (``status``
  is ``NOTE``, ``value`` unused). Either way ``notes`` is a (possibly
  empty) list of piggybacked notifications: §2.7/§2.8.4 task completions
  (with the home-node read buffer's state attached when it is small enough
  to ship — the piggyback read protocol) and deferred one-way errors.

Replies are matched to callers by ``req_id`` — normally by the *caller
itself*, leading its connection's read loop (the leader/follower demux in
``client.py``); out-of-order completion is the normal case (a blocking
gate-wait RPC parks server-side while later quick RPCs on the same socket
complete). A reply whose ``req_id`` is unknown (e.g. arriving after a
client-side timeout abandoned the call) is dropped with a log line, never
an error.

Server-to-server traffic (chain dispensing, the chained commit decision
``commit_wave``/``commit_decide`` hops, and the replication one-ways
``repl_apply``/``repl_final``/``repl_drop``/``repl_decision`` — DESIGN.md
§8) rides the exact same tagged frames: ops are strings, so the protocol
needs no new frame kinds, and FIFO per connection is what the replica
chain's tentative-before-decision ordering argument leans on.

A zero-length read means the peer closed the socket — the transport's
crash-stop signal (§3.4), surfaced as :class:`ConnectionClosed` and mapped
by the client onto :class:`~repro.core.api.RemoteObjectFailure`.

Frames are capped at :data:`MAX_FRAME` as a corrupted-peer guard. Pickle
implies the trust model documented in :mod:`repro.net`.
"""
from __future__ import annotations

import pickle
import socket
import struct
from typing import Any, List, Tuple

_LEN = struct.Struct("!I")
_SEG = struct.Struct("!BI")            # nbufs, pick_len
MAX_FRAME = 256 * 1024 * 1024  # corrupted length-word guard

OK = "ok"
ERR = "err"
NOTE = "note"

#: Largest pickled buffer state shipped to the client inside a task-done
#: note (the piggyback read protocol). Larger buffers stay home-node-only
#: and are read through ``buf_call`` RPCs — state never moves in bulk.
PIGGYBACK_MAX = 64 * 1024

#: Below this size an :func:`oob` payload stays in-band: a trailing
#: segment costs 4 header bytes plus an iovec entry, which only pays for
#: itself once the copy it avoids is non-trivial.
OOB_MIN = 2 * 1024


class WireError(RuntimeError):
    """Malformed traffic (oversized frame, undecodable payload)."""


class ConnectionClosed(ConnectionError):
    """The peer closed the connection (crash-stop detection signal)."""


def oob(data: bytes) -> Any:
    """Mark a bulk byte payload for out-of-band transport: it ships as a
    raw trailing frame segment (no re-copy into the pickle stream) and
    reconstructs as plain ``bytes`` at the receiver. Small payloads stay
    in-band — the segment overhead would outweigh the saved copy."""
    if len(data) >= OOB_MIN:
        return pickle.PickleBuffer(data)
    return data


def encode_segments(msg: Any) -> List[Any]:
    """The complete on-wire representation of one message as a segment
    list ``[header, pickle, *oob_buffers]`` — ready for one vectored
    ``sendmsg``, no concatenation."""
    bufs: List[pickle.PickleBuffer] = []
    try:
        pick = pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    except Exception as e:  # noqa: BLE001 - surface as a wire problem
        raise WireError(f"unencodable message: {e!r}") from e
    if not bufs:
        # Small-message fast path (the common tagged frame): one
        # contiguous buffer, so the sender's sendmsg degenerates to a
        # single plain send — no iovec bookkeeping for a 100-byte frame.
        total = _SEG.size + len(pick)
        if total > MAX_FRAME:
            raise WireError(f"frame too large: {total} bytes")
        if len(pick) < 65536:
            return [_LEN.pack(total) + _SEG.pack(0, len(pick)) + pick]
        return [_LEN.pack(total) + _SEG.pack(0, len(pick)), pick]
    views = [b.raw() for b in bufs]
    total = (_SEG.size + _LEN.size * len(views) + len(pick)
             + sum(len(v) for v in views))
    if total > MAX_FRAME:
        raise WireError(f"frame too large: {total} bytes")
    head = (_LEN.pack(total) + _SEG.pack(len(views), len(pick))
            + b"".join(_LEN.pack(len(v)) for v in views))
    return [head, pick, *views]


def decode_payload(view: Any) -> Any:
    """Decode one v3 payload (everything after the length word).
    ``view`` may be any bytes-like; out-of-band segments are materialized
    as independent ``bytes`` (safe to retain after the caller recycles
    its receive buffer)."""
    try:
        nbufs, pick_len = _SEG.unpack_from(view, 0)
        off = _SEG.size
        lens = []
        for _ in range(nbufs):
            (n,) = _LEN.unpack_from(view, off)
            lens.append(n)
            off += _LEN.size
        pick = view[off:off + pick_len]
        off += pick_len
        bufs = []
        for n in lens:
            bufs.append(bytes(view[off:off + n]))
            off += n
        return pickle.loads(pick, buffers=bufs)
    except WireError:
        raise
    except Exception as e:  # noqa: BLE001 - corrupt peer, not our bug
        raise WireError(f"undecodable payload: {e!r}") from e


def sendmsg_all(sock: socket.socket, segments: List[Any]) -> None:
    """``sendall`` semantics over one vectored ``sendmsg``: the normal
    case is a single syscall for the whole segment list; a partial write
    (full socket buffer) resumes from the exact byte."""
    if len(segments) == 1:
        sock.sendall(segments[0])           # common small-frame case
        return
    views = [memoryview(s) for s in segments]
    while views:
        sent = sock.sendmsg(views[:64])     # stay well under IOV_MAX
        while views and sent >= len(views[0]):
            sent -= len(views[0])
            views.pop(0)
        if sent and views:
            views[0] = views[0][sent:]


def send_msg(sock: socket.socket, msg: Any) -> None:
    sendmsg_all(sock, encode_segments(msg))


def send_frames(sock: socket.socket, chunks: List[Any]) -> None:
    """Coalesce several already-framed byte strings (from :func:`frame`)
    into one vectored send — queued outbound frames cost one syscall."""
    sendmsg_all(sock, chunks)


def frame(msg: Any) -> bytes:
    """The complete on-wire bytes of one message (length prefix included)
    as one contiguous buffer — for senders that need partial-write control
    (non-blocking pushes)."""
    return b"".join(bytes(s) if not isinstance(s, bytes) else s
                    for s in encode_segments(msg))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    chunks = []
    while n:
        chunk = sock.recv(n)
        if not chunk:
            raise ConnectionClosed("peer closed the connection")
        chunks.append(chunk)
        n -= len(chunk)
    return b"".join(chunks)


def recv_frame(sock: socket.socket) -> bytes:
    (length,) = _LEN.unpack(_recv_exact(sock, _LEN.size))
    if length > MAX_FRAME:
        raise WireError(f"frame too large: {length} bytes")
    return _recv_exact(sock, length) if length else b""


def recv_msg(sock: socket.socket) -> Any:
    return decode_payload(recv_frame(sock))


class FrameReader:
    """Buffered frame reader: one ``recv`` syscall drains as many pipelined
    frames as the kernel has queued, instead of two syscalls per frame.
    On a multiplexed connection carrying many small tagged messages this
    is the dominant syscall reduction.

    The receive buffer is a single reusable ``bytearray``; parsing runs
    over memoryviews of it and only out-of-band segments are copied out
    (they outlive the buffer). Single-reader use only — the client's
    leader/follower demux guarantees that by construction (exactly one
    leader per connection), and :meth:`has_frame` lets a departing leader
    drain every already-buffered frame without another syscall.
    """

    __slots__ = ("sock", "_buf")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = bytearray()

    def _fill(self, n: int) -> None:
        while len(self._buf) < n:
            chunk = self.sock.recv(max(65536, n - len(self._buf)))
            if not chunk:
                raise ConnectionClosed("peer closed the connection")
            self._buf += chunk

    def has_frame(self) -> bool:
        """True iff a complete frame is already buffered (zero syscalls)."""
        if len(self._buf) < _LEN.size:
            return False
        (length,) = _LEN.unpack_from(self._buf, 0)
        return len(self._buf) >= _LEN.size + length

    def recv_msg(self) -> Any:
        self._fill(_LEN.size)
        (length,) = _LEN.unpack_from(self._buf, 0)
        if length > MAX_FRAME:
            raise WireError(f"frame too large: {length} bytes")
        end = _LEN.size + length
        self._fill(end)
        view = memoryview(self._buf)
        try:
            msg = decode_payload(view[_LEN.size:end])
        except BaseException:
            # The in-flight exception's traceback pins views of _buf
            # (decode locals): rebuild instead of resizing the exported
            # buffer, which would raise BufferError.
            view.release()
            self._buf = self._buf[end:]
            raise
        view.release()
        del self._buf[:end]
        return msg


def encode_error(exc: BaseException) -> Any:
    """Return an exception object that survives pickling, degrading to a
    stringified ``RuntimeError`` when the original does not."""
    try:
        pickle.dumps(exc)
        return exc
    except Exception:  # noqa: BLE001
        return RuntimeError(f"{type(exc).__name__}: {exc}")


def parse_address(address: str) -> Tuple[str, int]:
    """``"host:port"`` → ``(host, port)``."""
    host, _, port = address.rpartition(":")
    return host or "127.0.0.1", int(port)
