"""WebSocket (RFC 6455) and a small HTTP/1.1 GET front on asyncio streams.

The session server and the live event stream need both, and the card's
machine has no ``websockets`` package, so the port frames its own.  It
imports only the standard library.

- ``serve(handler, host, port, http=...)`` answers each connection's GET:
  ``http(path)`` may return ``(status, body)`` for a plain HTTP answer
  (JSON); a request it leaves (``None``) must be a WebSocket upgrade, which
  is answered with 101 and ``Sec-WebSocket-Accept``, and ``handler`` is
  awaited with the ``WebSocket``.
- ``connect(uri)`` is the client: ``async with connect("ws://h:p/ws/id") as
  ws`` or ``ws = await connect(...)``.
- ``WebSocket``: ``send`` (a str goes as a text frame, bytes as a binary
  one), ``recv``, ``async for``, ``ping``, ``close``.  Frames carry 7-, 16-
  and 64-bit lengths; a client masks its frames and a server must not, and
  either side refuses the other's mistake with close code 1002; fragmented
  messages are joined, pings answered, a close echoed.  A message larger
  than ``max_size`` is refused with 1009 before it is buffered, a text
  message that is not UTF-8 with 1007.  No extension is negotiated.
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import os
import struct
import urllib.parse
from typing import Awaitable, Callable, Optional, Tuple, Union

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"
MAX_MESSAGE = 16 << 20  # bytes; a 1080p frame as base64 PNG fits
HANDSHAKE_TIMEOUT = 10.0  # seconds a peer has to send its request or answer
CLOSE_TIMEOUT = 5.0  # seconds to wait for the peer's close frame

OP_CONT, OP_TEXT, OP_BINARY, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10

Message = Union[str, bytes]


def accept_key(key: str) -> str:
    """The ``Sec-WebSocket-Accept`` answer to a ``Sec-WebSocket-Key``."""
    return base64.b64encode(hashlib.sha1((key + GUID).encode()).digest()).decode()


class ConnectionClosed(Exception):
    """The connection is closed; ``code`` is the close code (1006: no close
    frame was received)."""

    def __init__(self, code: int = 1006, reason: str = ""):
        super().__init__(f"WebSocket closed: {code} {reason}".strip())
        self.code = code
        self.reason = reason


class ProtocolError(Exception):
    def __init__(self, code: int, reason: str):
        super().__init__(reason)
        self.code = code
        self.reason = reason


def frame(opcode: int, payload: bytes, mask: bool, fin: bool = True) -> bytes:
    """One frame: a client's frames are masked with a random key."""
    head = bytearray([(0x80 if fin else 0) | opcode])
    n = len(payload)
    mbit = 0x80 if mask else 0
    if n < 126:
        head.append(mbit | n)
    elif n < 1 << 16:
        head.append(mbit | 126)
        head += struct.pack(">H", n)
    else:
        head.append(mbit | 127)
        head += struct.pack(">Q", n)
    if not mask:
        return bytes(head) + payload
    key = os.urandom(4)
    return bytes(head) + key + _unmask(payload, key)


def _unmask(data: bytes, key: bytes) -> bytes:
    n = len(data)
    if not n:
        return b""
    k = int.from_bytes((key * (n // 4 + 1))[:n], "little")
    return (int.from_bytes(data, "little") ^ k).to_bytes(n, "little")


class WebSocket:
    """One open WebSocket connection, server or client side."""

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 client: bool, path: str = "/", max_size: int = MAX_MESSAGE):
        self.reader = reader
        self.writer = writer
        self.client = client
        self.path = path
        self.max_size = max_size
        self.close_code: Optional[int] = None  # set once closed
        self._sent_close = False
        self._reading = False  # a recv is waiting on the stream
        self._write_lock = asyncio.Lock()

    # -- sending ----------------------------------------------------------

    async def _write(self, data: bytes) -> None:
        async with self._write_lock:
            self.writer.write(data)
            await self.writer.drain()

    async def send(self, message: Message) -> None:
        """A str as a text frame, bytes as a binary frame."""
        if self.close_code is not None or self._sent_close:
            raise ConnectionClosed(self.close_code or 1006)
        if isinstance(message, str):
            op, payload = OP_TEXT, message.encode()
        else:
            op, payload = OP_BINARY, bytes(message)
        try:
            await self._write(frame(op, payload, self.client))
        except (ConnectionError, RuntimeError) as e:
            self._abort()
            raise ConnectionClosed(1006, repr(e)) from None

    async def ping(self, data: bytes = b"") -> None:
        await self._write(frame(OP_PING, data, self.client))

    async def close(self, code: int = 1000, reason: str = "") -> None:
        """Send a close frame, wait for the peer's (bounded), then close the
        stream."""
        if self.close_code is None and not self._sent_close:
            self._sent_close = True
            try:
                await self._write(frame(OP_CLOSE, struct.pack(">H", code) + reason.encode(),
                                        self.client))
                if self._reading:  # that recv reads the peer's close frame
                    return
                await asyncio.wait_for(self._await_close(), CLOSE_TIMEOUT)
            except (ConnectionError, RuntimeError, asyncio.TimeoutError, ConnectionClosed):
                pass
        self._abort(code if self.close_code is None else self.close_code)
        try:
            await self.writer.wait_closed()
        except (ConnectionError, RuntimeError):
            pass

    async def _await_close(self) -> None:
        while True:
            try:
                await self.recv()
            except ConnectionClosed:
                return

    def _abort(self, code: int = 1006) -> None:
        if self.close_code is None:
            self.close_code = code
        self.writer.close()

    # -- receiving --------------------------------------------------------

    async def _read_frame(self) -> Tuple[bool, int, bytes]:
        try:
            b0, b1 = await self.reader.readexactly(2)
        except (asyncio.IncompleteReadError, ConnectionError):
            raise ConnectionClosed(1006) from None
        fin, opcode, masked, n = bool(b0 & 0x80), b0 & 0x0F, bool(b1 & 0x80), b1 & 0x7F
        try:
            if b0 & 0x70:
                raise ProtocolError(1002, "reserved bits set (no extension was negotiated)")
            if opcode in (3, 4, 5, 6, 7) or opcode > OP_PONG:
                raise ProtocolError(1002, f"unknown opcode {opcode}")
            if masked == self.client:
                raise ProtocolError(1002, "a client must mask its frames and a server must not")
            if n == 126:
                (n,) = struct.unpack(">H", await self.reader.readexactly(2))
            elif n == 127:
                (n,) = struct.unpack(">Q", await self.reader.readexactly(8))
                if n >> 63:
                    raise ProtocolError(1002, "64-bit length with its top bit set")
            if opcode >= OP_CLOSE and (not fin or n > 125):
                raise ProtocolError(1002, "a control frame is fragmented or over 125 bytes")
            if n > self.max_size:
                raise ProtocolError(1009, f"a frame of {n} bytes exceeds {self.max_size}")
            key = await self.reader.readexactly(4) if masked else b""
            payload = await self.reader.readexactly(n)
        except (asyncio.IncompleteReadError, ConnectionError):
            raise ConnectionClosed(1006) from None
        return fin, opcode, _unmask(payload, key) if masked else payload

    async def recv(self) -> Message:
        """The next text (str) or binary (bytes) message; answers pings and
        the close handshake on the way.  Raises ``ConnectionClosed``."""
        if self.close_code is not None:
            raise ConnectionClosed(self.close_code)
        self._reading = True
        try:
            return await self._recv()
        finally:
            self._reading = False

    async def _recv(self) -> Message:
        parts, op, size = [], None, 0
        try:
            while True:
                fin, opcode, payload = await self._read_frame()
                if opcode == OP_PING:
                    await self._write(frame(OP_PONG, payload, self.client))
                    continue
                if opcode == OP_PONG:
                    continue
                if opcode == OP_CLOSE:
                    await self._on_close(payload)
                if opcode == OP_CONT:
                    if op is None:
                        raise ProtocolError(1002, "continuation frame without a message")
                elif op is not None:
                    raise ProtocolError(1002, "a new message inside a fragmented one")
                else:
                    op = opcode
                size += len(payload)
                if size > self.max_size:
                    raise ProtocolError(1009, f"a message over {self.max_size} bytes")
                parts.append(payload)
                if fin:
                    break
        except ProtocolError as e:
            self._reading = False
            await self.close(e.code, e.reason)
            raise ConnectionClosed(e.code, e.reason) from None
        data = b"".join(parts)
        if op == OP_BINARY:
            return data
        try:
            return data.decode()
        except UnicodeDecodeError:
            self._reading = False
            await self.close(1007, "text message is not UTF-8")
            raise ConnectionClosed(1007, "text message is not UTF-8") from None

    async def _on_close(self, payload: bytes) -> None:
        code, reason = 1005, ""
        if len(payload) == 1:
            raise ProtocolError(1002, "close frame of one byte")
        if len(payload) >= 2:
            (code,) = struct.unpack(">H", payload[:2])
            reason = payload[2:].decode(errors="replace")
        if not self._sent_close:
            self._sent_close = True
            echo = struct.pack(">H", code) if code != 1005 else b""
            try:
                await self._write(frame(OP_CLOSE, echo, self.client))
            except (ConnectionError, RuntimeError):
                pass
        self._abort(code)
        raise ConnectionClosed(code, reason)

    def __aiter__(self):
        return self

    async def __anext__(self) -> Message:
        try:
            return await self.recv()
        except ConnectionClosed:
            raise StopAsyncIteration from None

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()


# ---------------------------------------------------------------------------
# HTTP front and server
# ---------------------------------------------------------------------------

_REASONS = {101: "Switching Protocols", 200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 426: "Upgrade Required",
            431: "Request Header Fields Too Large"}


async def _read_head(reader: asyncio.StreamReader) -> Tuple[str, dict]:
    """The first line and the (lower-cased) headers of an HTTP head."""
    raw = await reader.readuntil(b"\r\n\r\n")
    lines = raw.decode("latin-1").split("\r\n")
    headers = {}
    for line in lines[1:]:
        if ":" in line:
            k, v = line.split(":", 1)
            headers[k.strip().lower()] = v.strip()
    return lines[0], headers


def _response(status: int, body: bytes = b"", headers: Optional[dict] = None) -> bytes:
    hdrs = dict(headers or {})
    if status != 101:
        hdrs.update({"Content-Type": "application/json", "Content-Length": str(len(body)),
                     "Connection": "close"})
    head = f"HTTP/1.1 {status} {_REASONS.get(status, '')}\r\n"
    head += "".join(f"{k}: {v}\r\n" for k, v in hdrs.items())
    return head.encode("latin-1") + b"\r\n" + body


HttpHandler = Callable[[str], Optional[Tuple[int, bytes]]]
WsHandler = Callable[[WebSocket], Awaitable[None]]


async def _serve_connection(reader, writer, handler: WsHandler, http: Optional[HttpHandler],
                            max_size: int) -> None:
    try:
        answer = await _handshake(reader, http)
        if answer is None:
            return
        writer.write(answer[0])
        await writer.drain()
        if answer[1] is None:  # a plain HTTP answer
            return
        ws = WebSocket(reader, writer, client=False, path=answer[1], max_size=max_size)
        try:
            await handler(ws)
        finally:
            await ws.close()
    except ConnectionError:
        pass
    finally:
        writer.close()


async def _handshake(reader, http: Optional[HttpHandler]):
    """(response bytes, the WebSocket's path or None for a plain answer), or
    None when the peer sent no request."""
    try:
        line, headers = await asyncio.wait_for(_read_head(reader), HANDSHAKE_TIMEOUT)
    except (asyncio.LimitOverrunError, ValueError):
        return _response(431, b'{"error": "request head too large"}\n'), None
    except (asyncio.IncompleteReadError, asyncio.TimeoutError, ConnectionError):
        return None
    parts = line.split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        return _response(400, b'{"error": "bad request line"}\n'), None
    method, path = parts[0], parts[1]
    if method != "GET":
        return _response(405, b'{"error": "only GET is served"}\n'), None
    answer = http(path) if http is not None else None
    if answer is not None:
        return _response(answer[0], answer[1]), None
    key = headers.get("sec-websocket-key", "")
    tokens = headers.get("connection", "").lower().replace(" ", "").split(",")
    if (headers.get("upgrade", "").lower() != "websocket" or "upgrade" not in tokens
            or headers.get("sec-websocket-version") != "13"):
        return _response(426, b'{"error": "a WebSocket upgrade is expected"}\n',
                         {"Sec-WebSocket-Version": "13", "Upgrade": "websocket"}), None
    try:
        if len(base64.b64decode(key, validate=True)) != 16:
            raise ValueError(key)
    except ValueError:
        return _response(400, b'{"error": "bad Sec-WebSocket-Key"}\n'), None
    return _response(101, headers={"Upgrade": "websocket", "Connection": "Upgrade",
                                   "Sec-WebSocket-Accept": accept_key(key)}), path


async def serve(handler: WsHandler, host: str, port: int, http: Optional[HttpHandler] = None,
                max_size: int = MAX_MESSAGE) -> asyncio.AbstractServer:
    """Listen on (host, port) (port 0: any free port, read back from
    ``server.sockets[0].getsockname()[1]``)."""
    return await asyncio.start_server(
        lambda r, w: _serve_connection(r, w, handler, http, max_size), host, port)


# ---------------------------------------------------------------------------
# client
# ---------------------------------------------------------------------------

class connect:
    """Open a client connection to a ``ws://host:port/path`` URI."""

    def __init__(self, uri: str, max_size: int = MAX_MESSAGE):
        self.uri = uri
        self.max_size = max_size
        self._ws: Optional[WebSocket] = None

    async def _open(self) -> WebSocket:
        u = urllib.parse.urlsplit(self.uri)
        if u.scheme != "ws":
            raise ValueError(f"only ws:// URIs are served, not {self.uri!r}")
        host, port = u.hostname, u.port or 80
        path = (u.path or "/") + (f"?{u.query}" if u.query else "")
        reader, writer = await asyncio.open_connection(host, port)
        key = base64.b64encode(os.urandom(16)).decode()
        writer.write((f"GET {path} HTTP/1.1\r\nHost: {host}:{port}\r\nUpgrade: websocket\r\n"
                      f"Connection: Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                      "Sec-WebSocket-Version: 13\r\n\r\n").encode("latin-1"))
        await writer.drain()
        try:
            line, headers = await asyncio.wait_for(_read_head(reader), HANDSHAKE_TIMEOUT)
        except BaseException:
            writer.close()
            raise
        status = line.split(" ")[1] if line.count(" ") >= 1 else ""
        if status != "101" or headers.get("sec-websocket-accept") != accept_key(key):
            writer.close()
            raise ConnectionError(f"WebSocket handshake with {self.uri} refused: {line!r}")
        return WebSocket(reader, writer, client=True, path=path, max_size=self.max_size)

    def __await__(self):
        return self._open().__await__()

    async def __aenter__(self) -> WebSocket:
        self._ws = await self._open()
        return self._ws

    async def __aexit__(self, *exc):
        await self._ws.close()
