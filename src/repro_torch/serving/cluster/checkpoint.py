"""Durable tenant checkpoints — versioned, atomic, CRC-verified.

The paper's TZP decomposition (Lemma 4.2) makes a streaming session's
durable state *small and exact*: the frozen :class:`~repro_torch.core.
config.MiningConfig`, the finalized closed-prefix counts plus the
epoch/closure signature, and the still-open tail buffer.  Everything else
— snapshot caches, query engines, built kernels — is a pure re-derivable
function of that state and is deliberately excluded, so a checkpoint is a
few counts and one tail window, not a dump of device memory.  Restoring
replays only the open tail; the byte-identity guarantee is asserted in
``tests/test_torch_cluster.py``, which also runs the kill/restart harness.

The format is the JAX package's, byte for byte (the same name, version,
canonical JSON, CRC32 and base64 arrays), so a checkpoint written by
either package restores in the other whenever its config's backend exists
in both (``ref``, ``numpy``) and its tail-layout signature agrees.

On-disk format (one JSON document per tenant)::

    {"format": "repro.session-checkpoint", "version": 1, "crc32": <int>,
     "tenant": <name>, "meta": {...}, "payload": {...}}

``payload`` is the :meth:`MotifSession.checkpoint_state` capture with
numpy arrays base64-encoded; ``meta`` is caller-owned replay bookkeeping
(the harness stores per-tenant stream offsets so a restart knows where to
resume the feed).  ``crc32`` covers the canonical JSON encoding of
``{tenant, meta, payload}`` — a truncated or bit-flipped file fails loudly
with :class:`CheckpointError` instead of restoring silently-wrong counts.
Writes go through a temp file + ``os.replace`` so a crash mid-write leaves
the previous checkpoint intact: the store never holds a torn file.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import re
import tempfile
import zlib

import numpy as np

FORMAT_NAME = "repro.session-checkpoint"
FORMAT_VERSION = 1

_NDARRAY_KEY = "__ndarray__"


class CheckpointError(RuntimeError):
    """A checkpoint file is missing, corrupt, or from an unknown format."""


def _encode(obj):
    """JSON-safe encoding of a checkpoint payload (numpy-aware)."""
    if isinstance(obj, np.ndarray):
        return {
            _NDARRAY_KEY: base64.b64encode(
                np.ascontiguousarray(obj).tobytes()).decode("ascii"),
            "dtype": str(obj.dtype),
            "shape": list(obj.shape),
        }
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, dict):
        return {str(k): _encode(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_encode(v) for v in obj]
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"cannot checkpoint value of type {type(obj).__name__}")


def _decode(obj):
    if isinstance(obj, dict):
        if _NDARRAY_KEY in obj:
            raw = base64.b64decode(obj[_NDARRAY_KEY])
            return np.frombuffer(raw, dtype=np.dtype(obj["dtype"])).reshape(
                obj["shape"]).copy()
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def _canonical_bytes(doc: dict) -> bytes:
    return json.dumps(doc, sort_keys=True, separators=(",", ":")).encode()


@dataclasses.dataclass(frozen=True)
class SessionCheckpoint:
    """One tenant's durable state plus caller-owned replay metadata."""

    tenant: str
    payload: dict          # MotifSession.checkpoint_state() capture
    meta: dict             # replay bookkeeping (e.g. stream offsets)
    version: int = FORMAT_VERSION

    @classmethod
    def capture(cls, session, meta: dict | None = None) -> "SessionCheckpoint":
        """Snapshot a live
        :class:`~repro_torch.serving.motif.MotifSession`."""
        state = session.checkpoint_state()
        return cls(tenant=state["name"], payload=state,
                   meta=dict(meta or {}))

    # -- wire format ---------------------------------------------------------

    def to_json(self) -> str:
        body = {
            "tenant": self.tenant,
            "meta": _encode(self.meta),
            "payload": _encode(self.payload),
        }
        doc = {
            "format": FORMAT_NAME,
            "version": self.version,
            "crc32": zlib.crc32(_canonical_bytes(body)),
            **body,
        }
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "SessionCheckpoint":
        try:
            doc = json.loads(text)
        except json.JSONDecodeError as e:
            raise CheckpointError(f"checkpoint is not valid JSON: {e}") from e
        if not isinstance(doc, dict) or doc.get("format") != FORMAT_NAME:
            raise CheckpointError(
                f"not a {FORMAT_NAME} document "
                f"(format={doc.get('format')!r})"
                if isinstance(doc, dict) else
                f"not a {FORMAT_NAME} document")
        version = doc.get("version")
        if version != FORMAT_VERSION:
            raise CheckpointError(
                f"unsupported checkpoint version {version!r} "
                f"(this build reads version {FORMAT_VERSION})")
        body = {k: doc.get(k) for k in ("tenant", "meta", "payload")}
        crc = zlib.crc32(_canonical_bytes(body))
        if crc != doc.get("crc32"):
            raise CheckpointError(
                f"checkpoint CRC mismatch for tenant {body['tenant']!r}: "
                f"stored {doc.get('crc32')}, computed {crc} — the file is "
                f"corrupt; refusing to restore")
        return cls(tenant=body["tenant"], payload=_decode(body["payload"]),
                   meta=_decode(body["meta"]) or {}, version=version)

    # -- file I/O ------------------------------------------------------------

    def save(self, path: str) -> str:
        """Atomically write this checkpoint to ``path`` (tmp + replace)."""
        directory = os.path.dirname(os.path.abspath(path)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, prefix=".ckpt-",
                                   suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(self.to_json())
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path

    @classmethod
    def load(cls, path: str) -> "SessionCheckpoint":
        try:
            with open(path) as f:
                text = f.read()
        except OSError as e:
            raise CheckpointError(f"cannot read checkpoint {path}: {e}") from e
        return cls.from_json(text)


def _filename(tenant: str) -> str:
    """Collision-free filename for an arbitrary tenant name."""
    slug = re.sub(r"[^A-Za-z0-9._-]", "_", tenant)[:48]
    tag = zlib.crc32(tenant.encode()) & 0xFFFFFFFF
    return f"{slug}-{tag:08x}.ckpt.json"


class CheckpointStore:
    """One directory of per-tenant checkpoint files.

    Each tenant owns exactly one file, overwritten atomically on every
    :meth:`save` — the store always holds each tenant's *latest complete*
    checkpoint, never a torn one (a kill mid-write leaves the previous
    file).  The tenant name lives inside the document; the filename is a
    sanitized slug + CRC tag purely so arbitrary names map to legal paths.
    """

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def path_for(self, tenant: str) -> str:
        return os.path.join(self.root, _filename(tenant))

    def save(self, checkpoint: SessionCheckpoint) -> str:
        return checkpoint.save(self.path_for(checkpoint.tenant))

    def load(self, tenant: str) -> SessionCheckpoint:
        path = self.path_for(tenant)
        if not os.path.exists(path):
            raise CheckpointError(
                f"no checkpoint for tenant {tenant!r} under {self.root}")
        ckpt = SessionCheckpoint.load(path)
        if ckpt.tenant != tenant:
            raise CheckpointError(
                f"checkpoint file {path} is for tenant {ckpt.tenant!r}, "
                f"not {tenant!r}")
        return ckpt

    def tenants(self) -> list[str]:
        names = []
        for fname in os.listdir(self.root):
            if not fname.endswith(".ckpt.json"):
                continue
            names.append(
                SessionCheckpoint.load(os.path.join(self.root, fname)).tenant)
        return sorted(names)

    def load_all(self) -> dict[str, SessionCheckpoint]:
        return {t: self.load(t) for t in self.tenants()}

    def delete(self, tenant: str) -> bool:
        try:
            os.unlink(self.path_for(tenant))
            return True
        except FileNotFoundError:
            return False
