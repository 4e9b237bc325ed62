"""Key-value chunk stores: filesystem, HTTP and S3 with SigV4 (counterpart
of ``omero_ms_pixel_buffer_tpu/io/stores.py``).

A store maps relative keys (``0/.zarray``, ``0/0.0.1.2.3``) to bytes;
None means the key does not exist (Zarr fill_value: an absent chunk is
legitimate).

- ``FileStore``: a directory root.
- ``HTTPStore``: any static HTTP server exposing the hierarchy
  (``https://host/path/<key>``); 404 and 410 read as absent.
- ``S3Store``: ``s3://bucket/prefix`` with AWS Signature V4 over the
  standard library. Credentials come from the environment
  (``AWS_ACCESS_KEY_ID``, ``AWS_SECRET_ACCESS_KEY``,
  ``AWS_SESSION_TOKEN``, region ``AWS_REGION``) or the shared
  ``~/.aws/credentials`` and ``~/.aws/config`` files (profile
  ``AWS_PROFILE``); no credentials means unsigned requests.
  ``OMPB_S3_ENDPOINT`` points at another endpoint (MinIO, a local stub)
  with path-style addressing; ``OMPB_S3_403_AS_MISSING=1`` reads a 403
  as an absent chunk (buckets without ``s3:ListBucket``).

Remote stores speak ``get_range`` (ranged GETs, the Range header signed
for S3) and ``get_many`` (the planner of ``io/fetch.py``). Transient
failures (5xx, dropped connections) retry under the jittered policy of
``resilience/retry.py``; 4xx never retries. Each remote store has its
dependency's circuit breaker: repeated failures open it, and GETs then
fail fast with ``StoreUnavailableError`` (-> 503) until a half-open
probe heals it.

The write half serves the ingest plane: ``FileStore.put`` writes a
same-directory temporary file (fsynced) and renames it onto the key, and
``S3Store.put`` is one signed PUT up to ``multipart_threshold`` (64 MiB),
a multipart upload of 16 MiB parts above it. Either way a reader sees
the whole old object or the whole new one. ``HTTPStore`` has no ``put``:
the ingest plane answers 409 for an image on it.
"""

from __future__ import annotations

import configparser
import datetime
import hashlib
import hmac
import os
import tempfile
import time
import urllib.parse
from typing import List, Optional, Sequence, Tuple

from ..resilience.breaker import for_dependency
from .fetch import (
    POOL,
    FetchStats,
    RangeReq,
    StoreError,
    StoreUnavailableError,
    fetch_many,
    project_range,
    resilient_get,
)

__all__ = ["FileStore", "HTTPStore", "S3Store", "StoreError", "StoreUnavailableError",
           "make_store", "sigv4_headers", "validate_key"]

_EMPTY_SHA256 = hashlib.sha256(b"").hexdigest()


def load_shared_credentials(
    profile: Optional[str] = None,
) -> Tuple[Optional[str], Optional[str], Optional[str], Optional[str]]:
    """(access_key, secret_key, session_token, region) of ``profile``
    (default ``AWS_PROFILE``, else 'default') from the shared AWS files
    (``AWS_SHARED_CREDENTIALS_FILE`` / ``~/.aws/credentials`` and
    ``AWS_CONFIG_FILE`` / ``~/.aws/config``); all None when nothing is
    configured."""
    profile = profile or os.environ.get("AWS_PROFILE", "default")
    cred_path = os.environ.get(
        "AWS_SHARED_CREDENTIALS_FILE",
        os.path.join(os.path.expanduser("~"), ".aws", "credentials"))
    conf_path = os.environ.get(
        "AWS_CONFIG_FILE", os.path.join(os.path.expanduser("~"), ".aws", "config"))
    access = secret = token = region = None
    # strict=False and no interpolation: real files carry duplicate
    # sections and '%' in secrets; one bad file keeps the other's values
    try:
        if os.path.exists(cred_path):
            ini = configparser.RawConfigParser(strict=False)
            ini.read(cred_path)
            if ini.has_section(profile):
                access = ini.get(profile, "aws_access_key_id", fallback=None)
                secret = ini.get(profile, "aws_secret_access_key", fallback=None)
                token = ini.get(profile, "aws_session_token", fallback=None)
    except (configparser.Error, OSError):
        pass
    try:
        if os.path.exists(conf_path):
            ini = configparser.RawConfigParser(strict=False)
            ini.read(conf_path)
            # the config file spells other sections "profile <name>"
            section = profile if profile == "default" else f"profile {profile}"
            if ini.has_section(section):
                region = ini.get(section, "region", fallback=None)
    except (configparser.Error, OSError):
        pass
    return access, secret, token, region


def _range_header(start: int, length: Optional[int]) -> str:
    """RFC 7233 spelling of ``[start, start+length)``; a negative
    ``start`` is a suffix range (the last ``-start`` bytes)."""
    if start < 0:
        return f"bytes={start}"
    if length is None:
        return f"bytes={start}-"
    return f"bytes={start}-{start + length - 1}"


def validate_key(key: str) -> str:
    """Reject keys that could escape the store root (NGFF metadata names
    dataset paths verbatim): absolute and drive-letter paths and any
    ``..`` segment are store errors, never fill_value."""
    if key.startswith(("/", "\\")) or (len(key) > 1 and key[1] == ":" and key[0].isalpha()):
        raise StoreError(f"absolute store key rejected: {key!r}")
    if ".." in key.replace("\\", "/").split("/"):
        raise StoreError(f"path-traversal store key rejected: {key!r}")
    return key


class FileStore:
    def __init__(self, root: str):
        self.root = root

    def get(self, key: str) -> Optional[bytes]:
        path = os.path.join(self.root, validate_key(key))
        try:
            with open(path, "rb") as f:
                return f.read()
        except (FileNotFoundError, IsADirectoryError):
            return None

    def get_range(self, key: str, start: int, length: Optional[int] = None) -> Optional[bytes]:
        """Bytes ``[start, start+length)``; a negative ``start`` reads a
        suffix. A short object returns what it has (the Zarr layer checks
        lengths)."""
        path = os.path.join(self.root, validate_key(key))
        try:
            with open(path, "rb") as f:
                if start < 0:
                    f.seek(0, os.SEEK_END)
                    f.seek(max(0, f.tell() + start))
                else:
                    f.seek(start)
                return f.read() if length is None else f.read(length)
        except (FileNotFoundError, IsADirectoryError):
            return None

    def get_many(self, requests: Sequence[RangeReq],
                 stats: Optional[FetchStats] = None) -> List[Optional[bytes]]:
        return fetch_many(self, requests, stats=stats)

    def put(self, key: str, data: bytes) -> None:
        """Atomic whole-object write: the bytes land in a fsynced temporary
        file beside the key, then ``os.replace`` puts it in place, so a
        concurrent reader sees the whole old object or the whole new one."""
        path = os.path.join(self.root, validate_key(key))
        parent = os.path.dirname(path) or "."
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".", suffix=".tmp",
                                   dir=parent)
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def describe(self) -> str:
        return self.root


class HTTPStore:
    """Read-only store over HTTP(S) GETs through the shared keep-alive
    pool, with ranged GETs and batched reads."""

    def __init__(self, base_url: str, timeout_s: float = 30.0):
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        netloc = urllib.parse.urlsplit(self.base_url).netloc
        self.breaker = for_dependency(f"store:http:{netloc}")

    def _url(self, key: str) -> str:
        return f"{self.base_url}/{urllib.parse.quote(validate_key(key))}"

    def get(self, key: str) -> Optional[bytes]:
        url = self._url(key)
        status, body = resilient_get(lambda: POOL.request(url, {}, self.timeout_s),
                                     breaker=self.breaker, name=self.base_url, point="store.http")
        if status == 200:
            return body
        if status in (404, 410):
            return None
        raise StoreError(f"HTTP {status} for {url}")

    def get_range(self, key: str, start: int, length: Optional[int] = None) -> Optional[bytes]:
        """One ranged GET: 206 answers the range, a 200 (the origin
        ignores Range) is sliced here, a 416 is a store error."""
        url = self._url(key)
        headers = {"range": _range_header(start, length)}
        status, body = resilient_get(lambda: POOL.request(url, headers, self.timeout_s),
                                     breaker=self.breaker, name=self.base_url,
                                     point="io.range-get")
        if status == 206:
            return body
        if status == 200:
            return project_range(body, start, length)
        if status in (404, 410):
            return None
        raise StoreError(f"HTTP {status} for ranged {url}")

    def get_many(self, requests: Sequence[RangeReq],
                 stats: Optional[FetchStats] = None) -> List[Optional[bytes]]:
        return fetch_many(self, requests, stats=stats)

    def describe(self) -> str:
        return self.base_url


def _resolve_credentials(
    read_files_for_region: bool = False, prefer_files: bool = False,
) -> Tuple[Optional[str], Optional[str], Optional[str], Optional[str]]:
    """(access, secret, token, file_region): the environment's keys, else
    the shared files' (an environment token wins over the file's). The
    files are read when keys are missing, or for the region. With
    ``prefer_files`` (the 403 refresh) a complete file set, token
    included, replaces the environment's: only the files can rotate
    after start-up."""
    access = os.environ.get("AWS_ACCESS_KEY_ID")
    secret = os.environ.get("AWS_SECRET_ACCESS_KEY")
    token = os.environ.get("AWS_SESSION_TOKEN")
    file_region = None
    if not (access and secret) or read_files_for_region or prefer_files:
        f_access, f_secret, f_token, file_region = load_shared_credentials()
        if f_access and f_secret:
            if prefer_files:
                access, secret, token = f_access, f_secret, f_token
            elif not (access and secret):
                access, secret = f_access, f_secret
                token = token or f_token
    return access, secret, token, file_region


# a 403 is the normal answer for an absent key on a bucket without
# ListBucket, so re-reading the credential files is throttled
_CRED_REFRESH_MIN_S = 60.0


def _sign(key: bytes, msg: str) -> bytes:
    return hmac.new(key, msg.encode(), hashlib.sha256).digest()


def _canonical_query(query: Optional[dict]) -> str:
    """The SigV4 canonical query string (sorted keys, RFC 3986
    percent-encoding)."""
    return "&".join(
        f"{urllib.parse.quote(str(k), safe='-_.~')}={urllib.parse.quote(str(v), safe='-_.~')}"
        for k, v in sorted((query or {}).items()))


def sigv4_headers(
    method: str,
    host: str,
    canonical_uri: str,
    region: str,
    access_key: str,
    secret_key: str,
    session_token: Optional[str] = None,
    payload_sha256: str = _EMPTY_SHA256,
    now: Optional[datetime.datetime] = None,
    service: str = "s3",
    extra_headers: Optional[dict] = None,
    query: Optional[dict] = None,
) -> dict:
    """AWS Signature Version 4 headers (standalone, so a server can check
    them). ``extra_headers`` (a ranged GET's ``range``) join the
    signature; ``query`` enters the canonical request and must be sent
    as given; ``now`` fixes the signing time."""
    now = now or datetime.datetime.now(datetime.timezone.utc)
    amz_date = now.strftime("%Y%m%dT%H%M%SZ")
    datestamp = now.strftime("%Y%m%d")
    headers = {"host": host, "x-amz-content-sha256": payload_sha256, "x-amz-date": amz_date}
    if extra_headers:
        headers.update({k.lower(): v for k, v in extra_headers.items()})
    if session_token:
        headers["x-amz-security-token"] = session_token
    signed = ";".join(sorted(headers))
    canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
    canonical_request = "\n".join([method, canonical_uri, _canonical_query(query),
                                   canonical_headers, signed, payload_sha256])
    scope = f"{datestamp}/{region}/{service}/aws4_request"
    string_to_sign = "\n".join([
        "AWS4-HMAC-SHA256", amz_date, scope,
        hashlib.sha256(canonical_request.encode()).hexdigest()])
    k = _sign(("AWS4" + secret_key).encode(), datestamp)
    k = _sign(k, region)
    k = _sign(k, service)
    k = _sign(k, "aws4_request")
    signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
    headers["authorization"] = (
        f"AWS4-HMAC-SHA256 Credential={access_key}/{scope}, "
        f"SignedHeaders={signed}, Signature={signature}")
    return headers


class S3Store:
    """``s3://bucket/prefix`` over the standard library and SigV4. The
    endpoint is ``OMPB_S3_ENDPOINT`` (path-style) or
    ``https://<bucket>.s3.<region>.amazonaws.com`` (virtual-hosted)."""

    def __init__(self, uri: str, endpoint: Optional[str] = None,
                 region: Optional[str] = None, timeout_s: float = 60.0):
        parsed = urllib.parse.urlparse(uri)
        if parsed.scheme != "s3" or not parsed.netloc:
            raise ValueError(f"not an s3 URI: {uri}")
        self.bucket = parsed.netloc
        self.prefix = parsed.path.strip("/")
        self.region = region or os.environ.get("AWS_REGION") or os.environ.get(
            "AWS_DEFAULT_REGION", "us-east-1")
        self.timeout_s = timeout_s
        endpoint = endpoint or os.environ.get("OMPB_S3_ENDPOINT")
        if endpoint:
            self._base = endpoint.rstrip("/")
            self._path_style = True
        else:
            self._base = f"https://{self.bucket}.s3.{self.region}.amazonaws.com"
            self._path_style = False
        env_region = os.environ.get("AWS_REGION") or os.environ.get("AWS_DEFAULT_REGION")
        access, secret, token, file_region = _resolve_credentials(
            read_files_for_region=not (region or env_region))
        if file_region and not (region or env_region):
            self.region = file_region
            if not endpoint:  # the virtual-hosted URL tracks the region
                self._base = f"https://{self.bucket}.s3.{self.region}.amazonaws.com"
        # one tuple: a refresh swaps it whole, so a concurrent signer
        # never reads a mixed key pair
        self._creds = (access, secret, token)
        self._last_refresh_mono = float("-inf")
        # without s3:ListBucket S3 answers 403 for a key that does not
        # exist; reading that as absent is opt-in
        self.treat_403_as_missing = os.environ.get("OMPB_S3_403_AS_MISSING", "0") == "1"
        self.breaker = for_dependency(f"store:s3:{self.bucket}")

    def _url_and_path(self, key: str) -> Tuple[str, str]:
        rel = f"{self.prefix}/{key}" if self.prefix else key
        quoted = urllib.parse.quote(rel)
        path = f"/{self.bucket}/{quoted}" if self._path_style else f"/{quoted}"
        return self._base + path, path

    def _refresh_candidate(self) -> Optional[Tuple]:
        """Credentials re-read from the environment and the shared files
        (files first), or None when throttled, unchanged or incomplete. Not
        committed here: the caller retries with them and keeps them only
        when the answer stops being 403 (on a bucket without ListBucket a
        403 is the normal answer for an absent key)."""
        now = time.monotonic()
        if now - self._last_refresh_mono < _CRED_REFRESH_MIN_S:
            return None
        self._last_refresh_mono = now
        access, secret, token, _ = _resolve_credentials(prefer_files=True)
        fresh = (access, secret, token)
        if fresh == self._creds or not (access and secret):
            return None
        return fresh

    def _signed_request(self, method: str, key: str, body: Optional[bytes] = None,
                        creds: Optional[Tuple] = None, extra_headers: Optional[dict] = None,
                        point: str = "store.s3",
                        query: Optional[dict] = None) -> Tuple[int, bytes]:
        """One SigV4-signed request through the shared pool (unsigned
        without credentials). A write (PUT, POST, DELETE) signs its
        payload's sha256 and the query string (multipart uploads); a GET
        signs the empty payload."""
        url, canonical_path = self._url_and_path(key)
        if query:
            url += "?" + _canonical_query(query)
        access, secret, token = creds if creds is not None else self._creds
        headers: dict = dict(extra_headers or {})
        if access and secret:
            host = urllib.parse.urlparse(url).netloc
            headers = sigv4_headers(
                method, host, canonical_path, self.region, access, secret, token,
                payload_sha256=(hashlib.sha256(body or b"").hexdigest()
                                if method != "GET" else _EMPTY_SHA256),
                extra_headers=extra_headers, query=query)
        return resilient_get(
            lambda: POOL.request(url, headers, self.timeout_s, method=method, body=body),
            breaker=self.breaker, name=f"s3://{self.bucket}", point=point)

    def _signed_get(self, key: str, creds: Optional[Tuple] = None,
                    extra_headers: Optional[dict] = None,
                    point: str = "store.s3") -> Tuple[int, bytes]:
        return self._signed_request("GET", key, creds=creds, extra_headers=extra_headers,
                                    point=point)

    def _get_refreshing(self, key: str, extra_headers: Optional[dict] = None,
                        point: str = "store.s3") -> Tuple[int, bytes]:
        """A signed GET; on a 403, one retry with re-read credentials,
        kept only if the 403 stops (before any 403-as-missing mapping, so
        stale keys never read an existing chunk as absent)."""
        status, body = self._signed_get(key, extra_headers=extra_headers, point=point)
        if status == 403:
            fresh = self._refresh_candidate()
            if fresh is not None:
                status2, body2 = self._signed_get(key, creds=fresh, extra_headers=extra_headers,
                                                  point=point)
                if status2 != 403:
                    self._creds = fresh  # rotation confirmed
                    status, body = status2, body2
        return status, body

    def get(self, key: str) -> Optional[bytes]:
        validate_key(key)
        status, body = self._get_refreshing(key)
        if status == 200:
            return body
        if status == 404:
            return None
        if status == 403 and self.treat_403_as_missing:
            return None
        detail = ""
        if status == 403 and (b"ExpiredToken" in body or b"TokenRefreshRequired" in body):
            detail = (" (session token expired — rotate AWS_SESSION_TOKEN or"
                      " ~/.aws/credentials; IMDS refresh is not implemented)")
        raise StoreError(f"S3 {status} for s3://{self.bucket}/{key}{detail}")

    def get_range(self, key: str, start: int, length: Optional[int] = None) -> Optional[bytes]:
        """One signed ranged GET (the Range header joins the signature):
        206 answers the range, a 200 is sliced here, 416 is an error."""
        validate_key(key)
        status, body = self._get_refreshing(
            key, extra_headers={"range": _range_header(start, length)}, point="io.range-get")
        if status == 206:
            return body
        if status == 200:
            return project_range(body, start, length)
        if status == 404:
            return None
        if status == 403 and self.treat_403_as_missing:
            return None
        raise StoreError(f"S3 {status} for ranged s3://{self.bucket}/{key}")

    def get_many(self, requests: Sequence[RangeReq],
                 stats: Optional[FetchStats] = None) -> List[Optional[bytes]]:
        return fetch_many(self, requests, stats=stats)

    # a multipart part is at least 5 MiB (S3's minimum, but for the
    # last); S3 shows the key only at CompleteMultipartUpload, so a large
    # shard still publishes atomically
    multipart_threshold = 64 << 20
    multipart_part_size = 16 << 20

    def put(self, key: str, data: bytes) -> None:
        """SigV4-signed whole-object write: one PUT up to
        ``multipart_threshold``, a multipart upload above it. The key
        serves the previous object or the whole new one; an aborted
        upload never shows. Part ETags are the parts' MD5s, computed
        here (S3's ETag of a part without SSE-KMS)."""
        validate_key(key)
        if len(data) <= self.multipart_threshold:
            status, _ = self._signed_request("PUT", key, body=data)
            if status != 200:
                raise StoreError(f"S3 PUT {status} for s3://{self.bucket}/{key}")
            return
        self._multipart_put(key, data)

    def _multipart_put(self, key: str, data: bytes) -> None:
        status, body = self._signed_request("POST", key, body=b"", query={"uploads": ""})
        if status != 200:
            raise StoreError(f"S3 CreateMultipartUpload {status} for s3://{self.bucket}/{key}")
        text = body.decode("utf-8", "replace")
        lo, hi = text.find("<UploadId>"), text.find("</UploadId>")
        if lo < 0 or hi < 0:
            raise StoreError(f"S3 CreateMultipartUpload returned no UploadId for "
                             f"s3://{self.bucket}/{key}")
        upload_id = text[lo + len("<UploadId>"):hi]
        try:
            etags = []
            psize = self.multipart_part_size
            for n, off in enumerate(range(0, len(data), psize), 1):
                part = data[off:off + psize]
                status, _ = self._signed_request(
                    "PUT", key, body=part, query={"partNumber": n, "uploadId": upload_id})
                if status != 200:
                    raise StoreError(f"S3 UploadPart {status} (part {n}) for "
                                     f"s3://{self.bucket}/{key}")
                etags.append(hashlib.md5(part).hexdigest())
            complete = "".join(f"<Part><PartNumber>{n}</PartNumber>"
                               f"<ETag>&quot;{etag}&quot;</ETag></Part>"
                               for n, etag in enumerate(etags, 1))
            payload = f"<CompleteMultipartUpload>{complete}</CompleteMultipartUpload>".encode()
            status, body = self._signed_request("POST", key, body=payload,
                                                query={"uploadId": upload_id})
            # S3 can answer 200 with an <Error> body for a failed complete
            if status != 200 or b"<Error>" in body:
                raise StoreError(f"S3 CompleteMultipartUpload {status} for "
                                 f"s3://{self.bucket}/{key}")
        except BaseException:
            try:  # best effort: no half-uploaded parts left to accrue
                self._signed_request("DELETE", key, query={"uploadId": upload_id})
            except Exception:
                pass
            raise

    def describe(self) -> str:
        return f"s3://{self.bucket}/{self.prefix}"


def make_store(uri: str):
    """The store of a URI: ``s3://``, ``http(s)://`` or a path."""
    if uri.startswith("s3://"):
        return S3Store(uri)
    if uri.startswith(("http://", "https://")):
        return HTTPStore(uri)
    return FileStore(uri)
