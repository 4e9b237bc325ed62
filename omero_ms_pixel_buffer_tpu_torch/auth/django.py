"""Django / OMERO.web session payload decoding (a copy of
``omero_ms_pixel_buffer_tpu/auth/django.py``, the PyTorch port's own: it
imports nothing of the JAX package).

The reference's session stores (omero-ms-core
OmeroWebRedisSessionStore / OmeroWebJDBCSessionStore, installed at
PixelBufferMicroserviceVerticle.java:262-276) read OMERO.web's Django
session rows and extract the OMERO session key from the pickled
``connector`` object inside the session dict.

OMERO.web serializes sessions as base64(hmac_sha1 + ":" pickle) (the
classic Django PickleSerializer layout) or raw pickle (cache backend).
The connector is an ``omeroweb.connector.Connector`` instance — a class
this process doesn't have — so unpickling uses a tolerant Unpickler
that materializes unknown classes as attribute bags, then pulls
``omero_session_key`` out of the connector.

Django >= 3.1 defaults to the signed-JSON encoding instead
(``django.core.signing.dumps``): ``[.]urlsafe-b64(json or
zlib(json)) ":" base62-timestamp ":" hmac-signature``. A current
OMERO.web deployment stores sessions in that layout, so it is decoded
here too. The signature is NOT verified — this process has no Django
``SECRET_KEY``, and the reference's stores likewise treat the session
backend itself (Redis/Postgres reachable only by the deployment) as
the trust boundary.
"""

from __future__ import annotations

import base64
import io
import json
import pickle
import zlib
from typing import Any, Optional


class _Stub:
    """Attribute bag standing in for unimportable classes
    (omeroweb.connector.Connector et al.)."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_args"] = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


class _TolerantUnpickler(pickle.Unpickler):
    """NEVER resolves real classes: every GLOBAL/STACK_GLOBAL opcode
    materializes an inert attribute bag. Session payloads come from a
    store an attacker may be able to write to (shared Redis), and a
    resolving unpickler is arbitrary code execution (os.system via
    REDUCE). Extraction only needs dicts/strings/attribute bags, which
    pickle encodes without find_class."""

    def find_class(self, module, name):
        return type(name, (_Stub,), {"__module__": module})


def _loads(data: bytes) -> Any:
    return _TolerantUnpickler(io.BytesIO(data)).load()


def _decode_signed_json(payload: bytes) -> Optional[dict]:
    """django.core.signing.dumps layout (TimestampSigner.sign_object,
    the Django >= 3.1 session default): exactly three ":"-separated
    segments — ``[.]urlsafe-b64-payload : base62-timestamp :
    signature`` (the base64 alphabet cannot contain ":"). A leading "."
    on the payload marks zlib compression (sign_object's compress=True,
    which SessionBase.encode always passes)."""
    try:
        text = payload.decode("ascii").strip()
    except UnicodeDecodeError:
        return None
    parts = text.split(":")
    if len(parts) != 3 or not parts[0]:
        return None
    data = parts[0]
    is_compressed = data.startswith(".")
    if is_compressed:
        data = data[1:]
    try:
        raw = base64.urlsafe_b64decode(data + "=" * (-len(data) % 4))
        if is_compressed:
            raw = zlib.decompress(raw)
        obj = json.loads(raw.decode("utf-8"))
    except Exception:
        return None
    return obj if isinstance(obj, dict) else None


def decode_session_payload(payload: bytes) -> Optional[dict]:
    """Decode a Django session payload into the session dict. Handles:
    raw pickle, zlib pickle, base64("hash:pickle") legacy layouts, the
    signed-JSON layout (Django >= 3.1 default), and bare JSON (cache
    backends configured with the JSONSerializer). Returns None when
    nothing decodes."""
    signed = _decode_signed_json(payload)
    if signed is not None:
        return signed
    candidates = [payload]
    try:
        candidates.append(zlib.decompress(payload))
    except Exception:
        pass
    try:
        decoded = base64.b64decode(payload)
        candidates.append(decoded)
        if b":" in decoded:
            candidates.append(decoded.split(b":", 1)[1])
    except Exception:
        pass
    for cand in candidates:
        try:
            obj = _loads(cand)
        except Exception:
            obj = None
        if isinstance(obj, dict):
            return obj
        try:
            obj = json.loads(cand.decode("utf-8"))
        except Exception:
            continue
        if isinstance(obj, dict):
            return obj
    return None


def extract_omero_session_key(session: dict) -> Optional[str]:
    """Pull the OMERO session key from a decoded OMERO.web session dict
    (the OmeroWebSessionStore contract: session -> key or None)."""
    connector = session.get("connector")
    if connector is None:
        return None
    if isinstance(connector, dict):
        return connector.get("omero_session_key")
    return getattr(connector, "omero_session_key", None)
