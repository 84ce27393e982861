"""Wire-accurate in-process Azure Blob fake for tests (the Azurite
role). Speaks the Blob REST subset the backend uses — Put/Get(Range)/
Delete/Head Blob, List Blobs with markers — and VERIFIES SharedKey
signatures with the identical canonicalization the real service applies
(shared_key_string_to_sign from storage/azure.py), so the signing path
is tested end to end."""

from __future__ import annotations

import hmac
import threading
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .azure import shared_key_signature, shared_key_string_to_sign


class FakeAzureServer:
    def __init__(self, account: str = "devacct", access_key: str = ""):
        self.account = account
        self.access_key = access_key  # base64; "" disables verification
        # container -> blob name -> bytes
        self.blobs: dict[str, dict[str, bytes]] = {}
        # qwlint: disable-next-line=QW008 - storage base/fakes leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self.lock = threading.Lock()
        self.request_log: list[tuple[str, str]] = []
        self.auth_failures = 0
        self.fail_requests = 0
        self.list_page_size: Optional[int] = None  # force pagination
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # noqa: D102 - silence
                pass

            def _reply(self, status: int, body: bytes = b"",
                       headers: Optional[dict] = None) -> None:
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                if self.command != "HEAD":
                    self.wfile.write(body)

            def _parts(self):
                parsed = urllib.parse.urlparse(self.path)
                query = urllib.parse.parse_qsl(parsed.query,
                                               keep_blank_values=True)
                segments = urllib.parse.unquote(
                    parsed.path).lstrip("/").split("/", 1)
                container = segments[0]
                blob = segments[1] if len(segments) > 1 else ""
                return parsed, container, blob, query

            def _check_auth(self, resource_path, query) -> bool:
                if not server.access_key:
                    return True
                auth = self.headers.get("Authorization", "")
                if not auth.startswith(f"SharedKey {server.account}:"):
                    return False
                presented = auth.rsplit(":", 1)[1]
                headers = {k.lower(): v for k, v in self.headers.items()}
                expected = shared_key_signature(
                    server.access_key,
                    shared_key_string_to_sign(
                        self.command, headers, server.account,
                        resource_path, list(query)))
                if not hmac.compare_digest(expected, presented):
                    server.auth_failures += 1
                    return False
                return True

            def _common(self):
                parsed, container, blob, query = self._parts()
                # ALWAYS consume the body first: replying 500/403 without
                # reading it would desync the keep-alive stream and make
                # the client's retry parse stale bytes as a request line
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                with server.lock:
                    server.request_log.append((self.command, parsed.path))
                    if server.fail_requests > 0:
                        server.fail_requests -= 1
                        self._reply(500, b"<Error>boom</Error>")
                        return None
                resource_path = "/" + urllib.parse.quote(
                    f"{container}/{blob}" if blob else container,
                    safe="/-_.~")
                if not self._check_auth(resource_path, query):
                    self._reply(403, b"<Error>AuthenticationFailed</Error>")
                    return None
                return container, blob, dict(query), body

            def do_PUT(self):  # noqa: N802
                common = self._common()
                if common is None:
                    return
                container, blob, _query, body = common
                if self.headers.get("x-ms-blob-type") != "BlockBlob":
                    return self._reply(400, b"<Error>MissingBlobType</Error>")
                with server.lock:
                    server.blobs.setdefault(container, {})[blob] = body
                self._reply(201)

            def do_DELETE(self):  # noqa: N802
                common = self._common()
                if common is None:
                    return
                container, blob, _query, _body = common
                with server.lock:
                    existed = server.blobs.get(container, {}).pop(blob, None)
                self._reply(202 if existed is not None else 404)

            def do_HEAD(self):  # noqa: N802
                self._get_or_head()

            def do_GET(self):  # noqa: N802
                self._get_or_head()

            def _get_or_head(self):
                common = self._common()
                if common is None:
                    return
                container, blob, query, _body = common
                if query.get("comp") == "list":
                    return self._list(container, query)
                with server.lock:
                    data = server.blobs.get(container, {}).get(blob)
                if data is None:
                    return self._reply(404, b"<Error>BlobNotFound</Error>")
                range_header = self.headers.get("Range") or \
                    self.headers.get("x-ms-range")
                if range_header and range_header.startswith("bytes="):
                    lo, _, hi = range_header[6:].partition("-")
                    start = int(lo)
                    end = int(hi) + 1 if hi else len(data)
                    if start >= len(data):
                        return self._reply(416)
                    chunk = data[start:min(end, len(data))]
                    return self._reply(206, chunk, {
                        "Content-Range":
                            f"bytes {start}-{start + len(chunk) - 1}"
                            f"/{len(data)}"})
                self._reply(200, data)

            def _list(self, container: str, query: dict) -> None:
                prefix = query.get("prefix", "")
                marker = query.get("marker", "")
                with server.lock:
                    names = sorted(n for n in
                                   server.blobs.get(container, {})
                                   if n.startswith(prefix))
                if marker:
                    names = [n for n in names if n > marker]
                next_marker = ""
                if server.list_page_size is not None \
                        and len(names) > server.list_page_size:
                    names = names[: server.list_page_size]
                    next_marker = names[-1]
                blobs_xml = "".join(
                    f"<Blob><Name>{n}</Name></Blob>" for n in names)
                body = (f"<?xml version=\"1.0\"?><EnumerationResults>"
                        f"<Blobs>{blobs_xml}</Blobs>"
                        f"<NextMarker>{next_marker}</NextMarker>"
                        f"</EnumerationResults>").encode()
                self._reply(200, body,
                            {"Content-Type": "application/xml"})

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self._thread: Optional[threading.Thread] = None

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self._httpd.server_port}"

    def start(self) -> "FakeAzureServer":
        # qwlint: disable-next-line=QW003 - test-double HTTP server; no
        # query context exists on this path
        # qwlint: disable-next-line=QW008 - storage base/fakes leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
