"""The seam-wrapped router-to-replica transport funnel (counterpart of
``mxnet_tpu/serving/fleet/transport.py``).

Every dispatch and health probe the fleet router makes goes through the
three functions here, :func:`post_json`, :func:`get_json` and
:func:`call_local`, and nowhere else.  One choke point gives three
invariants:

- **chaos**: the ``router.dispatch`` / ``router.health_probe`` fault seams
  are checked here, inside the retried region, so an armed trip is
  absorbed exactly like a real network failure;
- **deadlines**: ``deadline`` is an absolute ``time.monotonic()`` second
  count and is *required*: a dispatch with no deadline would wedge a
  dispatcher thread on a dead replica forever;
- **retry policy**: transient failures ride the fault plane's
  ``call_with_retries`` full-jitter policy, bounded per call by
  ``retries`` (the router passes its per-request budget).

No tensor library here: the router does no device work.
"""
from __future__ import annotations

import json
import time

from ... import fault as _fault
from ...base import MXNetError

__all__ = ["TransportError", "ReplicaHTTPError", "post_json", "get_json",
           "call_local", "remaining_s"]


class TransportError(ConnectionError):
    """Router-to-replica transport failure (connect/send/receive).  A
    ConnectionError on purpose: ``fault.is_transient`` classifies it
    retryable with no special case."""


class ReplicaHTTPError(MXNetError):
    """The replica answered with a non-2xx status.  NOT transient (the
    reply proves the replica is alive); carries ``status`` and the decoded
    ``body`` so the router can relay 429/4xx semantics."""

    def __init__(self, status, body):
        super().__init__(f"replica HTTP {status}: {str(body)[:200]}")
        self.status = int(status)
        self.body = body


def remaining_s(deadline):
    """Seconds left until an absolute monotonic ``deadline``; raises
    TimeoutError (transient, so retry accounting stays uniform) when it
    already passed."""
    left = float(deadline) - time.monotonic()
    if left <= 0:
        raise TimeoutError("deadline exceeded before send")
    return left


def _http_round_trip(host, port, method, path, payload, deadline):
    # the one raw-HTTP site of the fleet package
    import http.client

    body = None
    if payload is not None:
        body = json.dumps(payload).encode()
    conn = http.client.HTTPConnection(host, int(port),
                                      timeout=remaining_s(deadline))
    try:
        try:
            headers = {"Content-Type": "application/json"} if body else {}
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            data = resp.read()
        except (OSError, http.client.HTTPException) as e:
            raise TransportError(f"{method} {host}:{port}{path}: "
                                 f"{e!r}") from e
    finally:
        conn.close()
    try:
        doc = json.loads(data) if data else None
    except ValueError:
        doc = {"raw": data.decode(errors="replace")}
    if resp.status >= 300:
        raise ReplicaHTTPError(resp.status, doc)
    return doc, dict(resp.getheaders())


def post_json(host, port, path, payload, *, deadline,
              seam="router.dispatch", retries=0, logger=None):
    """POST ``payload`` as JSON and return the decoded JSON reply.

    ``deadline`` (absolute monotonic seconds) is mandatory and bounds
    every attempt's socket timeout; ``retries`` bounds transient re-sends
    under the shared full-jitter backoff.  The ``seam`` check sits inside
    the retried region."""
    doc, _ = _fault.call_with_retries(
        seam, _http_round_trip, host, port, "POST", path, payload,
        deadline, retries=retries, logger=logger)
    return doc


def get_json(host, port, path, *, deadline, seam="router.health_probe",
             retries=0, logger=None):
    """GET and return the decoded JSON reply (the probe path: ``retries``
    defaults to 0, since a failed probe is data for the health state
    machine, not something to paper over)."""
    doc, _ = _fault.call_with_retries(
        seam, _http_round_trip, host, port, "GET", path, None,
        deadline, retries=retries, logger=logger)
    return doc


def call_local(fn, *args, deadline, seam="router.dispatch", retries=0,
               logger=None, **kwargs):
    """The in-process leg of the funnel: run ``fn`` under the same
    seam/deadline/retry contract as the HTTP legs, for ``LocalReplica``
    fleets.  ``fn`` sees the deadline through its own closure; this
    wrapper checks that it has not passed and arms the seam."""
    remaining_s(deadline)    # fail fast, as the HTTP legs do
    return _fault.call_with_retries(seam, fn, *args, retries=retries,
                                    logger=logger, **kwargs)
