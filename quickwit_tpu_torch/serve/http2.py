"""Minimal HTTP/2 (h2c prior-knowledge) server on stdlib sockets — the
transport under the gRPC surface (`grpc_server.py`).

Role of the reference's tonic/hyper HTTP/2 stack (`quickwit-serve/src/
grpc.rs:1`): this build has no HTTP/2 or gRPC library, so the protocol
subset a gRPC server needs is implemented here:

- connection preface + SETTINGS exchange, PING replies, GOAWAY
- HEADERS/CONTINUATION with full HPACK decoding (static + dynamic
  tables, integer prefix coding, Huffman-coded string literals via the
  RFC 7541 Appendix B table in `hpack_huffman.py`) — stock gRPC clients
  (grpc-core Huffman-encodes headers by default) interoperate; see the
  grpcio-client tests
- DATA with flow control (generous WINDOW_UPDATEs keep senders moving)
- response HEADERS + DATA + trailers (gRPC's status trailers), encoded
  as literal-without-indexing raw strings (always-valid HPACK)

Counterpart of the JAX package's `serve/http2.py`: the same frames and
HPACK bytes for the same headers.
"""

from __future__ import annotations

import socket
import ssl
import struct
import threading
from typing import Callable, Optional

FRAME_DATA = 0x0
FRAME_HEADERS = 0x1
FRAME_PRIORITY = 0x2
FRAME_RST_STREAM = 0x3
FRAME_SETTINGS = 0x4
FRAME_PING = 0x6
FRAME_GOAWAY = 0x7
FRAME_WINDOW_UPDATE = 0x8
FRAME_CONTINUATION = 0x9

FLAG_END_STREAM = 0x1
FLAG_END_HEADERS = 0x4
FLAG_ACK = 0x1
FLAG_PADDED = 0x8
FLAG_PRIORITY = 0x20

PREFACE = b"PRI * HTTP/2.0\r\n\r\nSM\r\n\r\n"

# RFC 7541 Appendix A static table (1-based)
HPACK_STATIC = [
    (":authority", ""), (":method", "GET"), (":method", "POST"),
    (":path", "/"), (":path", "/index.html"), (":scheme", "http"),
    (":scheme", "https"), (":status", "200"), (":status", "204"),
    (":status", "206"), (":status", "304"), (":status", "400"),
    (":status", "404"), (":status", "500"), ("accept-charset", ""),
    ("accept-encoding", "gzip, deflate"), ("accept-language", ""),
    ("accept-ranges", ""), ("accept", ""), ("access-control-allow-origin", ""),
    ("age", ""), ("allow", ""), ("authorization", ""), ("cache-control", ""),
    ("content-disposition", ""), ("content-encoding", ""),
    ("content-language", ""), ("content-length", ""), ("content-location", ""),
    ("content-range", ""), ("content-type", ""), ("cookie", ""), ("date", ""),
    ("etag", ""), ("expect", ""), ("expires", ""), ("from", ""), ("host", ""),
    ("if-match", ""), ("if-modified-since", ""), ("if-none-match", ""),
    ("if-range", ""), ("if-unmodified-since", ""), ("last-modified", ""),
    ("link", ""), ("location", ""), ("max-forwards", ""),
    ("proxy-authenticate", ""), ("proxy-authorization", ""), ("range", ""),
    ("referer", ""), ("refresh", ""), ("retry-after", ""), ("server", ""),
    ("set-cookie", ""), ("strict-transport-security", ""),
    ("transfer-encoding", ""), ("user-agent", ""), ("vary", ""), ("via", ""),
    ("www-authenticate", ""),
]


class Http2Error(RuntimeError):
    pass


class HpackDecoder:
    """RFC 7541 decoder: dynamic table + Huffman string literals."""

    def __init__(self, max_table_size: int = 4096):
        self.dynamic: list[tuple[str, str]] = []
        self.max_size = max_table_size
        self.size = 0

    def _entry(self, index: int) -> tuple[str, str]:
        if index <= 0:
            raise Http2Error("hpack index 0")
        if index <= len(HPACK_STATIC):
            return HPACK_STATIC[index - 1]
        dyn = index - len(HPACK_STATIC) - 1
        if dyn >= len(self.dynamic):
            raise Http2Error(f"hpack index {index} out of table")
        return self.dynamic[dyn]

    def _add(self, name: str, value: str) -> None:
        self.dynamic.insert(0, (name, value))
        self.size += len(name) + len(value) + 32
        while self.size > self.max_size and self.dynamic:
            n, v = self.dynamic.pop()
            self.size -= len(n) + len(v) + 32

    @staticmethod
    def _int(data: bytes, pos: int, prefix_bits: int) -> tuple[int, int]:
        mask = (1 << prefix_bits) - 1
        value = data[pos] & mask
        pos += 1
        if value < mask:
            return value, pos
        shift = 0
        while True:
            b = data[pos]
            pos += 1
            value += (b & 0x7F) << shift
            if not b & 0x80:
                return value, pos
            shift += 7

    def _string(self, data: bytes, pos: int) -> tuple[str, int]:
        huffman = bool(data[pos] & 0x80)
        length, pos = self._int(data, pos, 7)
        raw = data[pos: pos + length]
        pos += length
        if huffman:
            from .hpack_huffman import HuffmanError, huffman_decode
            try:
                raw = huffman_decode(bytes(raw))
            except HuffmanError as exc:
                raise Http2Error(f"bad huffman header literal: {exc}")
        return raw.decode("utf-8", "replace"), pos

    def decode(self, data: bytes) -> list[tuple[str, str]]:
        out: list[tuple[str, str]] = []
        pos = 0
        while pos < len(data):
            b = data[pos]
            if b & 0x80:                       # indexed
                index, pos = self._int(data, pos, 7)
                out.append(self._entry(index))
            elif b & 0x40:                     # literal, incremental index
                index, pos = self._int(data, pos, 6)
                name = (self._entry(index)[0] if index
                        else None)
                if name is None:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                self._add(name, value)
                out.append((name, value))
            elif b & 0x20:                     # dynamic table size update
                self.max_size, pos = self._int(data, pos, 5)
                while self.size > self.max_size and self.dynamic:
                    n, v = self.dynamic.pop()
                    self.size -= len(n) + len(v) + 32
            else:                              # literal, no/never index
                index, pos = self._int(data, pos, 4)
                name = self._entry(index)[0] if index else None
                if name is None:
                    name, pos = self._string(data, pos)
                value, pos = self._string(data, pos)
                out.append((name, value))
        return out


def hpack_encode_raw(headers: list[tuple[str, str]]) -> bytes:
    """Literal-without-indexing, raw strings — minimal always-valid
    HPACK (what the server emits and the in-repo client sends)."""
    out = bytearray()
    for name, value in headers:
        out.append(0x00)
        n = name.encode()
        v = value.encode()
        out += _hpack_int(len(n), 7) + n
        out += _hpack_int(len(v), 7) + v
    return bytes(out)


def _hpack_int(value: int, prefix_bits: int) -> bytes:
    mask = (1 << prefix_bits) - 1
    if value < mask:
        return bytes([value])
    out = bytearray([mask])
    value -= mask
    while value >= 0x80:
        out.append((value & 0x7F) | 0x80)
        value >>= 7
    out.append(value)
    return bytes(out)


def read_exact_from(sock: socket.socket, n: int) -> bytes:
    """recv() until exactly n bytes (shared by server and client)."""
    chunks = bytearray()
    while len(chunks) < n:
        chunk = sock.recv(n - len(chunks))
        if not chunk:
            raise Http2Error("connection closed")
        chunks += chunk
    return bytes(chunks)


def read_frame(read_exact) -> tuple[int, int, int, bytes]:
    header = read_exact(9)
    length = int.from_bytes(header[:3], "big")
    frame_type = header[3]
    flags = header[4]
    stream_id = int.from_bytes(header[5:9], "big") & 0x7FFFFFFF
    payload = read_exact(length) if length else b""
    return frame_type, flags, stream_id, payload


def frame(frame_type: int, flags: int, stream_id: int, payload: bytes) -> bytes:
    return (len(payload).to_bytes(3, "big") + bytes([frame_type, flags])
            + stream_id.to_bytes(4, "big") + payload)


class _Stream:
    def __init__(self, stream_id: int):
        self.stream_id = stream_id
        self.header_block = bytearray()
        self.headers: Optional[list[tuple[str, str]]] = None
        self.data = bytearray()
        self.headers_done = False
        self.ended = False


def _tls_duplex_bridge(tls_sock) -> socket.socket:
    """Bridge a server-side SSLSocket to a plaintext socketpair pumped by
    a single owner thread, and return the plaintext end.

    Why: the h2 connection logic is full-duplex — one thread blocks in
    the frame-read loop while dispatch threads send response frames — and
    OpenSSL does not allow SSL_read and SSL_write to run concurrently on
    one SSL object (a TLS1.3 KeyUpdate processed inside SSL_read while
    another thread is mid SSL_write corrupts the cipher state). Every SSL
    call below happens on the pump thread alone; the h2 code sees an
    ordinary full-duplex socket."""
    import select as select_mod

    plain, inner = socket.socketpair()
    tls_sock.settimeout(0)   # non-blocking: the pump multiplexes
    inner.settimeout(0)
    chunk = 1 << 16
    high_water = 1 << 20     # stop draining a side whose peer is slow

    def pump() -> None:
        # bytearrays: `del buf[:sent]` keeps partial drains O(n) (bytes
        # slicing would re-copy the tail on every partial send)
        to_tls = bytearray()    # from the h2 side, awaiting SSL_write
        to_inner = bytearray()  # decrypted, awaiting delivery to h2
        tls_eof = inner_eof = False
        # non-blocking SSL: a recv can demand socket WRITABILITY and a
        # send can demand READABILITY (key updates / renegotiation)
        recv_wants_write = send_wants_read = False
        try:
            while not (tls_eof and not to_inner) \
                    and not (inner_eof and not to_tls):
                rlist, wlist = [], []
                read_tls = (not tls_eof and len(to_inner) < high_water
                            and not recv_wants_write)
                if read_tls or send_wants_read:
                    rlist.append(tls_sock)
                if to_tls or recv_wants_write:
                    wlist.append(tls_sock)
                if not inner_eof and len(to_tls) < high_water:
                    rlist.append(inner)
                if to_inner:
                    wlist.append(inner)
                readable, writable, _ = select_mod.select(
                    rlist, wlist, [], 30.0)
                if not readable and not writable:
                    continue  # idle heartbeat tick
                tls_ready_r = tls_sock in readable
                tls_ready_w = tls_sock in writable
                if (not tls_eof and (tls_ready_r or
                                     (recv_wants_write and tls_ready_w))):
                    recv_wants_write = False
                    try:
                        while True:  # drain the SSL-internal buffer too
                            data = tls_sock.recv(chunk)
                            if not data:
                                tls_eof = True
                                break
                            to_inner += data
                            if not tls_sock.pending():
                                break
                    except ssl.SSLWantReadError:
                        pass
                    except ssl.SSLWantWriteError:
                        recv_wants_write = True
                if to_tls and (tls_ready_w or
                               (send_wants_read and tls_ready_r)):
                    send_wants_read = False
                    try:
                        sent = tls_sock.send(bytes(to_tls))
                        del to_tls[:sent]
                    except ssl.SSLWantWriteError:
                        pass
                    except ssl.SSLWantReadError:
                        send_wants_read = True
                if inner in readable:
                    data = inner.recv(chunk)
                    if not data:
                        inner_eof = True
                    else:
                        to_tls += data
                if to_inner and inner in writable:
                    sent = inner.send(to_inner)
                    del to_inner[:sent]
        except (OSError, ssl.SSLError):
            pass
        finally:
            for sock in (tls_sock, inner):
                try:
                    sock.close()
                except OSError:
                    pass

    # qwlint: disable-next-line=QW003 - byte-pump between the TLS and
    # plaintext halves of one socket; carries frames, not queries
    # qwlint: disable-next-line=QW008 - serve-layer transport infrastructure
    # (sockets, real IO) outside the DST-raced path; gating it would block the
    # token on real IO
    threading.Thread(target=pump, daemon=True,
                     name="h2-tls-pump").start()
    return plain


class Http2Server:
    """Threaded h2c server: one thread per connection, streams dispatched
    to `handler(headers, body) -> (response_headers, body_chunks,
    trailers)` as they END_STREAM."""

    def __init__(self, handler: Callable, host: str = "127.0.0.1",
                 port: int = 0, ssl_context=None):
        self.handler = handler
        # with an ssl_context the listener speaks HTTP/2 over TLS instead
        # of h2c — the TLS-cluster binary plane (ALPN h2 is baked into
        # the context where it is made, server_ssl_context(alpn=["h2"]))
        self._ssl_context = ssl_context
        self._server = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._server.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._server.bind((host, port))
        self._server.listen(16)
        self.host, self.port = self._server.getsockname()
        self._running = True
        # qwlint: disable-next-line=QW003 - listener accept loop: query
        # context is established per-request from the payload downstream
        # (deadline_millis -> deadline_scope), never inherited from here
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._running = False
        try:
            self._server.close()
        except OSError:
            pass

    def _serve(self) -> None:
        while self._running:
            try:
                conn, _addr = self._server.accept()
            except OSError:
                return
            # qwlint: disable-next-line=QW003 - connection thread; see
            # listener note above (context comes from each request)
            # qwlint: disable-next-line=QW008 - serve-layer transport
            # infrastructure (sockets, real IO) outside the DST-raced path;
            # gating it would block the token on real IO
            threading.Thread(target=self._connection, args=(conn,),
                             daemon=True).start()

    def _connection(self, conn: socket.socket) -> None:
        if self._ssl_context is not None:
            # handshake on the connection thread, BOUNDED: a silent or
            # stalled client must neither wedge the accept loop nor pin
            # this thread/fd forever (same 10s bound as the REST plane)
            try:
                conn.settimeout(10.0)
                conn = self._ssl_context.wrap_socket(conn, server_side=True)
                conn.settimeout(None)  # long-lived h2 connection
            except (OSError, ValueError):
                try:
                    conn.close()
                except OSError:
                    pass
                return
            # h2 is full-duplex (this reader thread + dispatch threads
            # writing responses), but OpenSSL forbids concurrent
            # SSL_read/SSL_write on one SSL object — bridge the TLS
            # socket to a plaintext socketpair owned by ONE pump thread
            conn = _tls_duplex_bridge(conn)
        state = _ConnState(conn)

        def read_exact(n: int) -> bytes:
            return read_exact_from(conn, n)

        send = state.send_raw
        try:
            if read_exact(len(PREFACE)) != PREFACE:
                return
            send(frame(FRAME_SETTINGS, 0, 0, b""))
            decoder = HpackDecoder()
            streams: dict[int, _Stream] = {}
            while True:
                frame_type, flags, stream_id, payload = read_frame(read_exact)
                if frame_type == FRAME_SETTINGS:
                    if not flags & FLAG_ACK:
                        state.apply_settings(payload)
                        send(frame(FRAME_SETTINGS, FLAG_ACK, 0, b""))
                    continue
                if frame_type == FRAME_PING:
                    if not flags & FLAG_ACK:
                        send(frame(FRAME_PING, FLAG_ACK, 0, payload))
                    continue
                if frame_type == FRAME_GOAWAY:
                    return
                if frame_type == FRAME_WINDOW_UPDATE:
                    increment = struct.unpack(">I", payload)[0] & 0x7FFFFFFF
                    state.add_window(stream_id, increment)
                    continue
                if frame_type in (FRAME_PRIORITY, FRAME_RST_STREAM):
                    continue
                if frame_type in (FRAME_HEADERS, FRAME_CONTINUATION):
                    stream = streams.setdefault(stream_id,
                                                _Stream(stream_id))
                    block = payload
                    if frame_type == FRAME_HEADERS:
                        if flags & FLAG_PADDED:
                            pad = block[0]
                            block = block[1: len(block) - pad]
                        if flags & FLAG_PRIORITY:
                            block = block[5:]
                    stream.header_block += block
                    if flags & FLAG_END_HEADERS:
                        stream.headers = decoder.decode(
                            bytes(stream.header_block))
                        stream.headers_done = True
                    if flags & FLAG_END_STREAM:
                        stream.ended = True
                elif frame_type == FRAME_DATA:
                    stream = streams.setdefault(stream_id,
                                                _Stream(stream_id))
                    block = payload
                    if flags & FLAG_PADDED:
                        pad = block[0]
                        block = block[1: len(block) - pad]
                    stream.data += block
                    # generous flow control: replenish both windows
                    if block:
                        increment = struct.pack(">I", len(block))
                        send(frame(FRAME_WINDOW_UPDATE, 0, 0, increment)
                             + frame(FRAME_WINDOW_UPDATE, 0, stream_id,
                                     increment))
                    if flags & FLAG_END_STREAM:
                        stream.ended = True
                if stream_id and stream_id in streams:
                    stream = streams[stream_id]
                    if stream.ended and stream.headers_done:
                        del streams[stream_id]
                        # qwlint: disable-next-line=QW003 - per-stream
                        # dispatch; the handler binds context from the
                        # decoded request, not from the reader thread
                        # qwlint: disable-next-line=QW008 - serve-layer
                        # transport infrastructure (sockets, real IO) outside
                        # the DST-raced path; gating it would block the token
                        # on real IO
                        threading.Thread(
                            target=self._dispatch,
                            args=(state, stream), daemon=True).start()
        except (Http2Error, OSError, IndexError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _dispatch(self, state: "_ConnState", stream: _Stream) -> None:
        try:
            response_headers, body_chunks, trailers = self.handler(
                stream.headers or [], bytes(stream.data))
        # qwlint: disable-next-line=QW004 - transport's last-resort 500:
        # typed exceptions are mapped to statuses by the gRPC/REST layers
        # above; anything reaching here is a handler bug, and raising
        # would kill the shared connection for unrelated streams
        except Exception:  # noqa: BLE001 - connection must survive
            response_headers = [(":status", "500")]
            body_chunks = []
            trailers = []
        header_flags = FLAG_END_HEADERS
        if not body_chunks and not trailers:
            header_flags |= FLAG_END_STREAM
        state.send_raw(frame(FRAME_HEADERS, header_flags, stream.stream_id,
                             hpack_encode_raw(response_headers)))
        for chunk in body_chunks:
            state.send_data(stream.stream_id, chunk)
        if trailers:
            state.send_raw(
                frame(FRAME_HEADERS, FLAG_END_HEADERS | FLAG_END_STREAM,
                      stream.stream_id, hpack_encode_raw(trailers)))
        elif body_chunks:
            state.send_raw(frame(FRAME_DATA, FLAG_END_STREAM,
                                 stream.stream_id, b""))


class _ConnState:
    """Per-connection write side: serialized writes, the peer's
    SETTINGS_MAX_FRAME_SIZE, and flow-control send windows (connection +
    per stream, RFC 7540 §5.2/§6.9) — DATA is split to the frame-size
    limit and blocks until window is available."""

    INITIAL_WINDOW = 65535

    def __init__(self, conn: socket.socket):
        self._conn = conn
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._lock = threading.Lock()
        # qwlint: disable-next-line=QW008 - serve-layer transport
        # infrastructure (sockets, real IO) outside the DST-raced path; gating
        # it would block the token on real IO
        self._window_cv = threading.Condition(self._lock)
        self.max_frame_size = 16384
        self._initial_stream_window = self.INITIAL_WINDOW
        self._conn_window = self.INITIAL_WINDOW
        self._stream_windows: dict[int, int] = {}

    def send_raw(self, data: bytes) -> None:
        with self._lock:
            self._conn.sendall(data)

    def apply_settings(self, payload: bytes) -> None:
        with self._window_cv:
            for i in range(0, len(payload) - 5, 6):
                ident = int.from_bytes(payload[i: i + 2], "big")
                value = int.from_bytes(payload[i + 2: i + 6], "big")
                if ident == 0x5:
                    self.max_frame_size = max(16384,
                                              min(value, (1 << 24) - 1))
                elif ident == 0x4:
                    delta = value - self._initial_stream_window
                    self._initial_stream_window = value
                    for sid in self._stream_windows:
                        self._stream_windows[sid] += delta
            self._window_cv.notify_all()

    def add_window(self, stream_id: int, increment: int) -> None:
        with self._window_cv:
            if stream_id == 0:
                self._conn_window += increment
            else:
                self._stream_windows[stream_id] = self._stream_windows.get(
                    stream_id, self._initial_stream_window) + increment
            self._window_cv.notify_all()

    def send_data(self, stream_id: int, data: bytes,
                  timeout: float = 30.0) -> None:
        offset = 0
        while offset < len(data):
            with self._window_cv:
                self._stream_windows.setdefault(
                    stream_id, self._initial_stream_window)
                budget = min(self._conn_window,
                             self._stream_windows[stream_id],
                             self.max_frame_size)
                if budget <= 0:
                    if not self._window_cv.wait(timeout=timeout):
                        raise Http2Error(
                            "flow-control window exhausted (peer sent no "
                            "WINDOW_UPDATE)")
                    continue
                chunk = data[offset: offset + budget]
                offset += len(chunk)
                self._conn_window -= len(chunk)
                self._stream_windows[stream_id] -= len(chunk)
                self._conn.sendall(frame(FRAME_DATA, 0, stream_id, chunk))
