"""Time one unary call of the port's gRPC plane on loopback, with the
plane's sockets as they are and with TCP_NODELAY set on both ends.

    python tools/grpc_nodelay_probe.py [--iters N] [--request-bytes N]
                                       [--response-bytes N]

The port's `Http2Server` writes a response as three frames (HEADERS, DATA,
trailers) in separate sends, and `GrpcChannel` sends a request as HEADERS
and DATA; without TCP_NODELAY the kernel may hold a small send until the
peer's delayed ACK. The option changes no byte on the wire. Defaults are
the sizes of phase 16's leaf request (the flagship over 8 hdfs splits) in
binwire. Prints one JSON object of p50/p90 ms per setting.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import sys
import time


def timed_calls(http2, grpc_server, nodelay: bool, iters: int,
                request: bytes, response: bytes) -> list:
    def handler(headers, body):
        return ([(":status", "200"), ("content-type", "application/grpc")],
                [grpc_server._grpc_frame(response)], [("grpc-status", "0")])

    accept = socket.socket.accept
    if nodelay:
        def accept_nodelay(sock):
            conn, addr = accept(sock)
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            return conn, addr
        socket.socket.accept = accept_nodelay
    try:
        server = http2.Http2Server(handler)
        channel = grpc_server.GrpcChannel(server.host, server.port)
    finally:
        socket.socket.accept = accept
    if nodelay:
        channel._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    try:
        channel.call("/probe/Call", request)
        walls = []
        for _ in range(iters):
            t0 = time.perf_counter()
            messages, status, _ = channel.call("/probe/Call", request)
            walls.append((time.perf_counter() - t0) * 1e3)
            if status != 0 or messages != [response]:
                raise AssertionError("probe call failed")
        return walls
    finally:
        channel.close()
        server.stop()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--request-bytes", type=int, default=2318)
    parser.add_argument("--response-bytes", type=int, default=1275)
    args = parser.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from quickwit_tpu_torch.serve import grpc_server, http2
    request = bytes(range(256)) * (args.request_bytes // 256 + 1)
    response = bytes(reversed(range(256))) * (args.response_bytes // 256 + 1)
    request, response = (request[:args.request_bytes],
                         response[:args.response_bytes])
    out = {"iters": args.iters, "request_bytes": len(request),
           "response_bytes": len(response)}
    for name, nodelay in (("as_ported", False), ("tcp_nodelay", True)):
        walls = timed_calls(http2, grpc_server, nodelay, args.iters,
                            request, response)
        q = statistics.quantiles(walls, n=10)
        out[name] = {"p50_ms": round(statistics.median(walls), 4),
                     "p90_ms": round(q[-1], 4)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
