"""The port's WebSocket framing (``serve/ws.py``, RFC 6455) and its HTTP
front: the handshake's accept key, frames of every length encoding, masking
rules, fragmentation, ping/pong, the close handshake, the message size cap,
and interoperation in both directions with the ``websockets`` package
(installed here; the card's machine has none).  Exact comparisons only:
framing has no tolerance."""

import asyncio
import base64
import os
import struct

import pytest
import websockets
import websockets.asyncio.server as ws_server

from mast3r_slam_tpu_torch.serve import ws

LENGTHS = [0, 125, 126, 65535, 65536]


def test_accept_key_is_the_rfc_example():
    # RFC 6455 section 1.3
    assert ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="


@pytest.mark.parametrize("n", LENGTHS)
def test_frame_length_encodings(n):
    payload = bytes(range(256)) * (n // 256) + bytes(n % 256)
    server_frame = ws.frame(ws.OP_BINARY, payload, mask=False)
    head = {0: 2, 125: 2, 126: 4, 65535: 4, 65536: 10}[n]
    assert server_frame[0] == 0x82 and len(server_frame) == head + n
    assert server_frame[head:] == payload
    if n >= 126:
        width = 2 if n < 65536 else 8
        assert server_frame[1] == (126 if width == 2 else 127)
        assert int.from_bytes(server_frame[2:2 + width], "big") == n
    client_frame = ws.frame(ws.OP_TEXT, payload, mask=True)
    assert client_frame[1] & 0x80 and len(client_frame) == head + 4 + n
    key = client_frame[head:head + 4]
    assert ws._unmask(client_frame[head + 4:], key) == payload


async def _echo(sock):
    async for message in sock:
        await sock.send(message)


async def _with_server(body, handler=_echo, **kw):
    srv = await ws.serve(handler, "127.0.0.1", 0, **kw)
    try:
        return await body(srv.sockets[0].getsockname()[1])
    finally:
        srv.close()
        await srv.wait_closed()


@pytest.mark.parametrize("n", LENGTHS)
def test_port_server_and_client_round_trip(n):
    async def body(port):
        async with ws.connect(f"ws://127.0.0.1:{port}/p") as c:
            text = "é" * (n // 2) + "a" * (n % 2)
            await c.send(text)
            assert await c.recv() == text
            data = os.urandom(n)
            await c.send(data)
            assert await c.recv() == data

    asyncio.run(_with_server(body))


@pytest.mark.parametrize("n", LENGTHS)
def test_websockets_client_against_the_port_server(n):
    async def body(port):
        async with websockets.connect(f"ws://127.0.0.1:{port}/x", max_size=None) as c:
            await c.send("t" * n)
            assert await c.recv() == "t" * n
            data = os.urandom(n)
            await c.send(data)
            assert await c.recv() == data
            await c.ping()

    asyncio.run(_with_server(body))


@pytest.mark.parametrize("n", LENGTHS)
def test_port_client_against_a_websockets_server(n):
    async def echo(sock):
        async for m in sock:
            await sock.send(m)

    async def run():
        async with ws_server.serve(echo, "127.0.0.1", 0, max_size=None) as srv:
            port = srv.sockets[0].getsockname()[1]
            async with ws.connect(f"ws://127.0.0.1:{port}/") as c:
                await c.send("u" * n)
                assert await c.recv() == "u" * n
                data = os.urandom(n)
                await c.send(data)
                assert await c.recv() == data
                await c.ping(b"hi")
                await c.send("after the pong")
                assert await c.recv() == "after the pong"

    asyncio.run(run())


async def _raw_client(port, path="/ws"):
    """A TCP connection past the handshake, writing frames by hand."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    key = base64.b64encode(os.urandom(16)).decode()
    writer.write((f"GET {path} HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n"
                  f"Connection: keep-alive, Upgrade\r\nSec-WebSocket-Key: {key}\r\n"
                  "Sec-WebSocket-Version: 13\r\n\r\n").encode())
    head = await reader.readuntil(b"\r\n\r\n")
    assert head.startswith(b"HTTP/1.1 101 ")
    assert f"Sec-WebSocket-Accept: {ws.accept_key(key)}".encode() in head
    return reader, writer


async def _read_server_frame(reader):
    b0, b1 = await reader.readexactly(2)
    assert not b1 & 0x80  # a server never masks
    n = b1 & 0x7F
    if n == 126:
        (n,) = struct.unpack(">H", await reader.readexactly(2))
    elif n == 127:
        (n,) = struct.unpack(">Q", await reader.readexactly(8))
    return b0 & 0x80, b0 & 0x0F, await reader.readexactly(n)


def test_fragments_are_joined_and_pings_answered_between_them():
    got = []

    async def collect(sock):
        got.append(await sock.recv())
        got.append(await sock.recv())

    async def body(port):
        reader, writer = await _raw_client(port)
        writer.write(ws.frame(ws.OP_TEXT, b"hel", mask=True, fin=False))
        writer.write(ws.frame(ws.OP_PING, b"p1", mask=True))
        writer.write(ws.frame(ws.OP_CONT, b"lo ", mask=True, fin=False))
        writer.write(ws.frame(ws.OP_CONT, "wörld".encode(), mask=True, fin=True))
        writer.write(ws.frame(ws.OP_BINARY, b"\x00\x01", mask=True, fin=False))
        writer.write(ws.frame(ws.OP_CONT, b"\x02", mask=True))
        await writer.drain()
        fin, op, payload = await _read_server_frame(reader)
        assert (fin, op, payload) == (0x80, ws.OP_PONG, b"p1")
        writer.write(ws.frame(ws.OP_CLOSE, struct.pack(">H", 1000), mask=True))
        await writer.drain()
        assert (await _read_server_frame(reader))[1] == ws.OP_CLOSE
        writer.close()

    asyncio.run(_with_server(body, handler=collect))
    assert got == ["hello wörld", b"\x00\x01\x02"]


def test_close_handshake_carries_the_code():
    closed = []

    async def handler(sock):
        try:
            await sock.recv()
        except ws.ConnectionClosed as e:
            closed.append((e.code, e.reason))

    async def body(port):
        c = await ws.connect(f"ws://127.0.0.1:{port}/")
        await c.close(4001, "bye")
        assert c.close_code == 4001
        with pytest.raises(ws.ConnectionClosed):
            await c.send("late")

    asyncio.run(_with_server(body, handler=handler))
    assert closed == [(4001, "bye")]


@pytest.mark.parametrize("frame,code", [
    (ws.frame(ws.OP_TEXT, b"unmasked", mask=False), 1002),           # a client must mask
    (bytes([0x81 | 0x40, 0x80 | 1]) + b"\x00" * 5, 1002),           # RSV1 without extension
    (ws.frame(ws.OP_PING, b"x" * 126, mask=True), 1002),             # control frame > 125
    (ws.frame(ws.OP_CONT, b"orphan", mask=True), 1002),              # continuation first
    (ws.frame(ws.OP_TEXT, b"\xff\xfe", mask=True), 1007),            # text not UTF-8
], ids=["unmasked", "rsv1", "long-ping", "orphan-continuation", "not-utf8"])  # masks are random
def test_protocol_errors_close_with_their_code(frame, code):
    seen = []

    async def handler(sock):
        try:
            await sock.recv()
        except ws.ConnectionClosed as e:
            seen.append(e.code)

    async def body(port):
        reader, writer = await _raw_client(port)
        writer.write(frame)
        await writer.drain()
        fin, op, payload = await _read_server_frame(reader)
        writer.close()
        return op, struct.unpack(">H", payload[:2])[0]

    assert asyncio.run(_with_server(body, handler=handler)) == (ws.OP_CLOSE, code)
    assert seen == [code]


def test_oversized_messages_are_refused_before_they_are_buffered():
    seen = []

    async def handler(sock):
        try:
            seen.append(await sock.recv())
            await sock.recv()
        except ws.ConnectionClosed as e:
            seen.append(e.code)

    async def body(port):
        reader, writer = await _raw_client(port)
        writer.write(ws.frame(ws.OP_BINARY, b"x" * 1000, mask=True))  # at the cap
        # a header announcing 2**40 bytes: refused from the header alone
        writer.write(bytes([0x82, 0x80 | 127]) + struct.pack(">Q", 1 << 40) + os.urandom(4))
        await writer.drain()
        fin, op, payload = await _read_server_frame(reader)
        writer.close()
        return op, struct.unpack(">H", payload[:2])[0]

    assert asyncio.run(_with_server(body, handler=handler, max_size=1000)) == (ws.OP_CLOSE, 1009)
    assert seen == [b"x" * 1000, 1009]

    async def fragments(port):  # the cap holds across fragments too
        reader, writer = await _raw_client(port)
        for _ in range(3):
            writer.write(ws.frame(ws.OP_BINARY if _ == 0 else ws.OP_CONT, b"y" * 400,
                                  mask=True, fin=False))
        await writer.drain()
        op, payload = (await _read_server_frame(reader))[1:]
        writer.close()
        return op, struct.unpack(">H", payload[:2])[0]

    seen.clear()

    async def only_close(sock):
        try:
            await sock.recv()
        except ws.ConnectionClosed as e:
            seen.append(e.code)

    assert asyncio.run(_with_server(fragments, handler=only_close, max_size=1000)) == \
        (ws.OP_CLOSE, 1009)
    assert seen == [1009]


def test_a_server_frame_with_a_mask_is_refused_by_the_client():
    async def run():
        async def handler(r, w):
            head = (await r.readuntil(b"\r\n\r\n")).decode()
            key = [l.split(": ")[1] for l in head.split("\r\n")
                   if l.lower().startswith("sec-websocket-key")][0]
            w.write((f"HTTP/1.1 101 Switching Protocols\r\nUpgrade: websocket\r\n"
                     f"Connection: Upgrade\r\nSec-WebSocket-Accept: {ws.accept_key(key)}"
                     "\r\n\r\n").encode())
            w.write(ws.frame(ws.OP_TEXT, b"masked", mask=True))
            await w.drain()
            await asyncio.sleep(0.5)
            w.close()

        srv = await asyncio.start_server(handler, "127.0.0.1", 0)
        port = srv.sockets[0].getsockname()[1]
        c = await ws.connect(f"ws://127.0.0.1:{port}/")
        with pytest.raises(ws.ConnectionClosed) as e:
            await c.recv()
        srv.close()
        return e.value.code

    assert asyncio.run(run()) == 1002


def test_http_front_answers_plain_gets_and_refuses_the_rest():
    def http(path):
        return (200, b'{"ok": 1}') if path == "/plain" else None

    async def get(port, request):
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        writer.write(request)
        await writer.drain()
        data = await reader.read()
        writer.close()
        return data

    async def body(port):
        plain = await get(port, b"GET /plain HTTP/1.1\r\nHost: x\r\n\r\n")
        no_upgrade = await get(port, b"GET /ws HTTP/1.1\r\nHost: x\r\n\r\n")
        post = await get(port, b"POST /plain HTTP/1.1\r\nHost: x\r\n\r\n")
        bad_key = await get(port, b"GET /ws HTTP/1.1\r\nUpgrade: websocket\r\n"
                                  b"Connection: Upgrade\r\nSec-WebSocket-Key: short\r\n"
                                  b"Sec-WebSocket-Version: 13\r\n\r\n")
        return plain, no_upgrade, post, bad_key

    plain, no_upgrade, post, bad_key = asyncio.run(_with_server(body, http=http))
    assert plain.startswith(b"HTTP/1.1 200 ") and plain.endswith(b'{"ok": 1}')
    assert no_upgrade.startswith(b"HTTP/1.1 426 ")
    assert post.startswith(b"HTTP/1.1 405 ")
    assert bad_key.startswith(b"HTTP/1.1 400 ")
