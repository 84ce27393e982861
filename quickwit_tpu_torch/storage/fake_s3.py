"""In-process fake S3 server for tests and benchmarks.

Role of the reference's localstack/MinIO-backed integration tests
(`quickwit-integration-tests/.localstack/`, and the `s3` feature of
`quickwit-storage` tests): an HTTP server speaking enough of the S3 REST
API to exercise `S3CompatibleStorage` end-to-end — object GET (with
Range), PUT, HEAD, DELETE, multi-object delete, and ListObjectsV2 —
plus two test-harness features the real service obviously lacks:

- **latency injection** (`latency_secs`, or a `latency_fn(method, key)`)
  so warmup/compute pipelining has real storage latency to hide;
- **fault injection** (`fail_requests`) to test retry paths;
- a **request log** so tests can assert GET counts (e.g. the ≤2-GET
  split-open guarantee) and inspect ranges.

When constructed with credentials it *verifies* SigV4 signatures by
re-deriving them server-side — a genuine conformance check of the
client's signer, not just an echo.
"""

from __future__ import annotations

import hashlib
import hmac
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

_XMLNS = 'xmlns="http://s3.amazonaws.com/doc/2006-03-01/"'


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


class FakeS3Server:
    def __init__(self, access_key: str = "", secret_key: str = "",
                 latency_secs: float = 0.0,
                 latency_fn: Optional[Callable[[str, str], float]] = None):
        self.access_key = access_key
        self.secret_key = secret_key
        self.latency_secs = latency_secs
        self.latency_fn = latency_fn
        self.objects: dict[str, dict[str, bytes]] = {}  # bucket -> key -> data
        self.ignore_range = False  # emulate servers that 200 full objects
        # qwlint: disable-next-line=QW008 - storage base/fakes leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self.lock = threading.Lock()
        self.request_log: list[tuple[str, str, dict]] = []
        self.fail_requests = 0        # fail the next N requests with 500
        self.auth_failures = 0        # count of rejected signatures
        server = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):  # noqa: D102 - silence
                pass

            def _object_path(self) -> tuple[str, str, dict[str, list[str]]]:
                parsed = urllib.parse.urlparse(self.path)
                query = urllib.parse.parse_qs(parsed.query,
                                              keep_blank_values=True)
                parts = urllib.parse.unquote(parsed.path).lstrip("/")
                bucket, _, key = parts.partition("/")
                return bucket, key, query

            def _reply(self, status: int, body: bytes = b"",
                       headers: Optional[dict] = None) -> None:
                self.send_response(status)
                for k, v in (headers or {}).items():
                    self.send_header(k, v)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _check_auth(self, body: bytes) -> bool:
                if not server.secret_key:
                    return True
                auth = self.headers.get("Authorization", "")
                if not auth.startswith("AWS4-HMAC-SHA256 "):
                    return False
                try:
                    fields = dict(
                        part.strip().split("=", 1)
                        for part in auth[len("AWS4-HMAC-SHA256 "):].split(","))
                    credential = fields["Credential"]
                    signed_headers = fields["SignedHeaders"]
                    signature = fields["Signature"]
                    _akid, datestamp, region, service, _term = \
                        credential.split("/")
                except (KeyError, ValueError):
                    return False
                parsed = urllib.parse.urlparse(self.path)
                query_pairs = urllib.parse.parse_qsl(
                    parsed.query, keep_blank_values=True)
                canonical_query = "&".join(
                    f"{urllib.parse.quote(k, safe='-_.~')}="
                    f"{urllib.parse.quote(v, safe='-_.~')}"
                    for k, v in sorted(query_pairs))
                names = signed_headers.split(";")
                canonical_headers = "".join(
                    f"{n}:{(self.headers.get(n) or '').strip()}\n"
                    for n in names)
                payload_sha = self.headers.get("x-amz-content-sha256",
                                               hashlib.sha256(b"").hexdigest())
                canonical_request = "\n".join([
                    self.command, urllib.parse.quote(
                        urllib.parse.unquote(parsed.path), safe="/-_.~"),
                    canonical_query, canonical_headers, signed_headers,
                    payload_sha])
                scope = f"{datestamp}/{region}/{service}/aws4_request"
                string_to_sign = "\n".join([
                    "AWS4-HMAC-SHA256",
                    self.headers.get("x-amz-date", ""), scope,
                    hashlib.sha256(canonical_request.encode()).hexdigest()])
                key = _sign(f"AWS4{server.secret_key}".encode(), datestamp)
                key = _sign(key, region)
                key = _sign(key, service)
                key = _sign(key, "aws4_request")
                expected = hmac.new(key, string_to_sign.encode(),
                                    hashlib.sha256).hexdigest()
                if not hmac.compare_digest(expected, signature):
                    server.auth_failures += 1
                    return False
                # integrity: payload hash must match the body we received
                if body and hashlib.sha256(body).hexdigest() != payload_sha:
                    server.auth_failures += 1
                    return False
                return True

            def _common(self) -> Optional[tuple[str, str, dict, bytes]]:
                bucket, key, query = self._object_path()
                length = int(self.headers.get("Content-Length") or 0)
                body = self.rfile.read(length) if length else b""
                with server.lock:
                    server.request_log.append(
                        (self.command, f"{bucket}/{key}",
                         {k.lower(): v for k, v in self.headers.items()}))
                    if server.fail_requests > 0:
                        server.fail_requests -= 1
                        self._reply(500, b"<Error>injected</Error>")
                        return None
                delay = (server.latency_fn(self.command, key)
                         if server.latency_fn else server.latency_secs)
                if delay:
                    time.sleep(delay)
                if not self._check_auth(body):
                    self._reply(403, b"<Error>SignatureDoesNotMatch</Error>")
                    return None
                return bucket, key, query, body

            # --- verbs -------------------------------------------------
            def do_PUT(self):
                common = self._common()
                if common is None:
                    return
                bucket, key, _, body = common
                with server.lock:
                    server.objects.setdefault(bucket, {})[key] = body
                self._reply(200)

            def do_HEAD(self):
                common = self._common()
                if common is None:
                    return
                bucket, key, _, _ = common
                with server.lock:
                    data = server.objects.get(bucket, {}).get(key)
                if data is None:
                    # HEAD responses carry no body
                    self.send_response(404)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()

            def do_GET(self):
                common = self._common()
                if common is None:
                    return
                bucket, key, query, _ = common
                if not key and "list-type" in query:
                    return self._list(bucket, query)
                with server.lock:
                    data = server.objects.get(bucket, {}).get(key)
                if data is None:
                    return self._reply(404, b"<Error>NoSuchKey</Error>")
                range_header = self.headers.get("Range")
                if server.ignore_range:
                    range_header = None
                if range_header and range_header.startswith("bytes="):
                    spec = range_header[len("bytes="):]
                    start_s, _, end_s = spec.partition("-")
                    if start_s == "":  # suffix range: last N bytes
                        start = max(0, len(data) - int(end_s))
                        end = len(data)
                    else:
                        start = int(start_s)
                        end = min(int(end_s) + 1 if end_s else len(data),
                                  len(data))
                    if start >= len(data):
                        return self._reply(416)
                    chunk = data[start:end]
                    return self._reply(
                        206, chunk,
                        {"Content-Range":
                         f"bytes {start}-{end - 1}/{len(data)}"})
                self._reply(200, data)

            def _list(self, bucket: str, query: dict) -> None:
                prefix = (query.get("prefix") or [""])[0]
                max_keys = int((query.get("max-keys") or ["1000"])[0])
                token = (query.get("continuation-token") or [""])[0]
                with server.lock:
                    keys = sorted(k for k in server.objects.get(bucket, {})
                                  if k.startswith(prefix))
                if token:
                    keys = [k for k in keys if k > token]
                page, rest = keys[:max_keys], keys[max_keys:]
                contents = "".join(
                    f"<Contents><Key>{k}</Key></Contents>" for k in page)
                truncated = "true" if rest else "false"
                next_token = (f"<NextContinuationToken>{page[-1]}"
                              "</NextContinuationToken>") if rest else ""
                body = (f'<ListBucketResult {_XMLNS}>'
                        f"<IsTruncated>{truncated}</IsTruncated>"
                        f"{next_token}{contents}</ListBucketResult>").encode()
                self._reply(200, body)

            def do_DELETE(self):
                common = self._common()
                if common is None:
                    return
                bucket, key, _, _ = common
                with server.lock:
                    existed = server.objects.get(bucket, {}).pop(key, None)
                if existed is None:
                    return self._reply(404, b"<Error>NoSuchKey</Error>")
                self._reply(204)

            def do_POST(self):
                common = self._common()
                if common is None:
                    return
                bucket, _, query, body = common
                if "delete" not in query:
                    return self._reply(400, b"<Error>unsupported</Error>")
                import xml.etree.ElementTree as ET
                root = ET.fromstring(body)
                deleted = []
                with server.lock:
                    for obj in root.iter("Object"):
                        key = obj.findtext("Key") or ""
                        server.objects.get(bucket, {}).pop(key, None)
                        deleted.append(key)
                self._reply(200, (f'<DeleteResult {_XMLNS}>'
                                  "</DeleteResult>").encode())

        self._httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self._httpd.server_address[1]
        self.endpoint = f"http://127.0.0.1:{self.port}"
        # qwlint: disable-next-line=QW003 - test-double HTTP server; no
        # query context exists on this path
        # qwlint: disable-next-line=QW008 - storage base/fakes leaf locks; pure
        # in-memory ops inside, never a seam primitive
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="fake-s3", daemon=True)

    # --- lifecycle -------------------------------------------------------
    def start(self) -> "FakeS3Server":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    def __enter__(self) -> "FakeS3Server":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # --- test helpers ----------------------------------------------------
    def get_requests(self, method: Optional[str] = None
                     ) -> list[tuple[str, str, dict]]:
        with self.lock:
            log = list(self.request_log)
        return [r for r in log if method is None or r[0] == method]

    def clear_log(self) -> None:
        with self.lock:
            self.request_log.clear()
