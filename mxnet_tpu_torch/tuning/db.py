"""Persistent per-signature tuning DB: search winners on disk (counterpart
of ``mxnet_tpu/tuning/db.py``).

A search measures candidates and publishes the winner; every later
process with the same workload, device and runtime replays it with zero
search trials.

Key = sha256 over the knob name, the workload signature (a repr-stable
tuple; ``None`` = the knob's global winner), the plan digest, the device
kind (``torch.cuda.get_device_name``: a winner tuned on one card does not
steer another) and the fingerprint: the torch version, the CUDA version,
the device name and this module's format version (so an upgraded runtime,
or the reference's entry, silently misses).

Entry format: one file per key, ``<keyhash>.tune`` = a JSON header line
(payload sha256, size, fingerprint, creation time) + a JSON payload
``{"knob", "value", "score", "default_score", "trials", "unit"}``,
written atomically (tmp + fsync + rename) and verified on read: **a
corrupt, truncated or mismatched entry is a silent miss, never a
crash**; the warm path runs the default and the next search overwrites
it.
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time

from .. import env as _env
from .. import telemetry as _telemetry

__all__ = ["TuningDB", "default_db", "resolve_db", "device_kind"]

_LOGGER = logging.getLogger(__name__)

# bump when the entry payload shape or the winner semantics change:
# old entries silently miss instead of steering with stale meaning
_FORMAT_VERSION = 1

_DB_HITS = _telemetry.counter(
    "mxnet_tuning_db_hits_total",
    "tuned winners served from the persistent tuning DB (each one is "
    "a knob search that did NOT happen)")
_DB_MISSES = _telemetry.counter(
    "mxnet_tuning_db_misses_total",
    "tuning-DB lookups that found no usable entry (unset, corrupt, "
    "version-mismatched, or out-of-grid)")
_DB_STORES = _telemetry.counter(
    "mxnet_tuning_db_stores_total",
    "search winners published into the persistent tuning DB")


def _fingerprint():
    import torch

    return f"torch={torch.__version__};cuda={torch.version.cuda}" \
           f";device={device_kind()};fmt={_FORMAT_VERSION}"


def device_kind():
    """The device kind a winner is valid for: the first card's name, or
    ``cpu`` without one."""
    try:
        import torch

        if torch.cuda.is_available():
            return str(torch.cuda.get_device_name(0))
    except Exception:
        pass
    return "cpu"


_DEFAULT = None
_DEFAULT_DIR = None


def default_db():
    """The session-default DB from ``MXNET_TUNE_DB_DIR`` (None when
    unset — without a directory there is nothing to replay)."""
    global _DEFAULT, _DEFAULT_DIR
    d = _env.tune_db_dir()
    if not d:
        return None
    if _DEFAULT is None or _DEFAULT_DIR != d:
        _DEFAULT = TuningDB(d)
        _DEFAULT_DIR = d
    return _DEFAULT


def resolve_db(explicit):
    """The DB a consumer should use: explicit wins, else the session
    default, else None."""
    return explicit if explicit is not None else default_db()


class TuningDB:
    """One on-disk winner directory (content-addressed, atomic-publish,
    sha256-verified)."""

    def __init__(self, directory, logger=None):
        self.directory = directory
        self.logger = logger or _LOGGER

    # -- keys --------------------------------------------------------------
    def key(self, knob_name, signature=None, plan_digest=None,
            device=None):
        """sha256 key for one winner — knob + workload signature + plan
        digest + device kind + torch/CUDA fingerprint."""
        doc = repr((str(knob_name), signature if signature is not None
                    else "global", plan_digest or "none",
                    device or device_kind(), _fingerprint()))
        return hashlib.sha256(doc.encode()).hexdigest()

    def _path(self, key):
        return os.path.join(self.directory, f"{key}.tune")

    # -- entries -----------------------------------------------------------
    def get(self, key):
        """The verified winner doc for ``key``, or None.  Every failure
        mode — missing file, torn header, truncated payload, checksum
        mismatch, fingerprint drift, non-dict payload — is a SILENT
        miss: the warm path runs the default instead."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                header = json.loads(f.readline())
                payload = f.read()
        except (OSError, ValueError):
            _DB_MISSES.inc()
            return None
        try:
            ok = (header.get("fingerprint") == _fingerprint()
                  and header.get("size") == len(payload)
                  and header.get("sha256") ==
                  hashlib.sha256(payload).hexdigest())
        except Exception:
            ok = False
        doc = None
        if ok:
            try:
                doc = json.loads(payload)
            except ValueError:
                doc = None
        if not isinstance(doc, dict) or "value" not in doc:
            _DB_MISSES.inc()
            self.logger.warning(
                "tuning DB entry %s failed verification; treating as a "
                "miss (the next search will overwrite it)", path)
            return None
        _DB_HITS.inc()
        return doc

    def put(self, key, doc):
        """Atomically publish a winner doc (tmp + fsync + rename;
        concurrent tuners converge on a complete file, a crash
        mid-write leaves no visible entry).  Returns False on OSError —
        the DB is an accelerator, not a dependency."""
        payload = json.dumps(doc, sort_keys=True).encode()
        header = {"sha256": hashlib.sha256(payload).hexdigest(),
                  "size": len(payload),
                  "fingerprint": _fingerprint(),
                  "time": time.time()}
        try:
            os.makedirs(self.directory, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=self.directory,
                                       prefix=".tmp_tune_")
        except OSError as e:
            self.logger.warning("tuning DB store failed: %r", e)
            return False
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(json.dumps(header).encode() + b"\n")
                f.write(payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(key))
        except OSError as e:
            self.logger.warning("tuning DB store failed: %r", e)
            try:
                os.unlink(tmp)
            except OSError:
                pass
            return False
        _DB_STORES.inc()
        return True

    # -- winner sugar ------------------------------------------------------
    def get_winner(self, knob, signature=None, plan_digest=None):
        """The stored winner VALUE for ``knob`` (a :class:`Knob`), or
        None.  Falls back from the exact signature to the knob's global
        winner, validates against the declared grid (a stale entry from
        an older grid degrades to a miss), and parses through the
        knob's type."""
        for sig in ((signature, plan_digest), (None, None)) \
                if signature is not None or plan_digest is not None \
                else ((None, None),):
            doc = self.get(self.key(knob.name, sig[0], sig[1]))
            if doc is None:
                continue
            value = knob.parse(doc.get("value"))
            if knob.validate(value):
                return value
            self.logger.warning(
                "tuning DB winner %r for knob %s is outside the "
                "declared grid %r; ignoring it", value, knob.name,
                knob.grid)
        return None

    def put_winner(self, knob, value, *, signature=None,
                   plan_digest=None, score=None, default_score=None,
                   trials=None, unit=None, publish_global=True):
        """Publish a search winner (see :meth:`get_winner` for the
        lookup side).  ``value`` is stored as a string so int/str knobs
        round-trip the same way env vars do.  With ``publish_global``
        (the default) a signature-keyed winner is ALSO published under
        the knob's global key — resolve sites without signature context
        (e.g. ``bucket_cap_bytes``) replay through the global fallback."""
        doc = {"format": _FORMAT_VERSION, "knob": knob.name,
               "value": str(value)}
        if score is not None:
            doc["score"] = float(score)
        if default_score is not None:
            doc["default_score"] = float(default_score)
        if trials is not None:
            doc["trials"] = int(trials)
        if unit:
            doc["unit"] = str(unit)
        ok = self.put(self.key(knob.name, signature, plan_digest), doc)
        if ok and publish_global and (signature is not None
                                      or plan_digest is not None):
            ok = self.put(self.key(knob.name, None, None),
                          dict(doc, signature=repr(signature)))
        return ok

    def stats(self):
        """Entry count + bytes on disk (observability helper)."""
        n, total = 0, 0
        try:
            for name in os.listdir(self.directory):
                if name.endswith(".tune"):
                    n += 1
                    total += os.path.getsize(
                        os.path.join(self.directory, name))
        except OSError:
            pass
        return {"entries": n, "bytes": total,
                "directory": self.directory}
