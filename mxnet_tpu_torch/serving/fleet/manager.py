"""Fleet manager: replica processes, replacement and scaling
(counterpart of ``mxnet_tpu/serving/fleet/manager.py``).

The router (router.py) owns dispatch; this module owns the replica
*set*: spawning engine replicas, replacing dead ones, and the scale-up and
scale-down hooks the :class:`policy.Autoscaler` drives.  Every spawn goes
through the ``fleet.spawn`` fault seam (``call_with_retries``: a tripped
or failed spawn retries under the shared policy instead of silently
shrinking the fleet).

Two replica modes share the machinery:

- **process mode** (:class:`ProcessReplica`): the manager launches
  ``spawn_cmd(rid)``'s argv (exec, no fork), waits for the engine's ready
  banner on its stdout, and talks HTTP through the transport funnel.
  Every spawn is cold: the child builds its weights and warms its engine
  (the reference's warm spawn through a shared compile cache has no
  counterpart in the port yet);
- **local mode** (``engine_factory``): in-process replicas.  The factory
  receives a running donor engine (or None); handing it to
  ``ServingEngine.join_replica`` shares the donor's weights, so a
  replacement costs one KV pool, not a second copy of the model.

A dead replica is reaped before its replacement is spawned: a local one's
engine is closed, which frees its KV pool on the card.

:func:`serve_fleet` is the blocking entry point, the multi-replica analog
of ``serving.serve``: router + N replicas + HTTP front door; SIGTERM drains
every replica and it returns ``lifecycle.EXIT_PREEMPTED``.
"""
from __future__ import annotations

import logging
import os
import re
import signal
import subprocess
import threading
import time

from ... import env as _env
from ... import fault as _fault
from ... import lifecycle as _lifecycle
from ... import telemetry as _telemetry
from ...base import MXNetError
from . import transport as _transport
from .router import ReplicaHandle, Router

__all__ = ["ProcessReplica", "FleetManager", "serve_fleet"]

_LOGGER = logging.getLogger(__name__)

_C_SPAWNS = _telemetry.counter(
    "mxnet_fleet_spawns_total",
    "replica spawns by kind (initial / replacement / scale_up)",
    labelnames=("kind",))
_H_SPAWN = _telemetry.histogram(
    "mxnet_fleet_spawn_seconds",
    "replica spawn -> ready wall time (a local join shares the donor's "
    "weights; a process spawn builds its own)")

# the engine's serve() ready banner IS the readiness protocol: one line,
# already printed ("mxnet_tpu_torch serving: engine up on 127.0.0.1:<port>")
_READY_RE = re.compile(r"engine up on 127\.0\.0\.1:(\d+)")


class ProcessReplica(ReplicaHandle):
    """A replica living in its own OS process, reached over HTTP
    through the transport funnel.  ``proc`` is the Popen handle (the
    liveness source: ``poll()`` catches a SIGKILL the instant the
    kernel reaps it, no probe timeout needed)."""

    def __init__(self, rid, proc, host, port, **kw):
        super().__init__(rid, **kw)
        self.proc = proc
        self.host = str(host)
        self.port = int(port)

    def alive(self):
        return self.proc.poll() is None

    def probe(self):
        return _transport.get_json(
            self.host, self.port, "/v1/serving",
            deadline=time.monotonic() + 1.0)

    def submit(self, freq, retries=0):
        payload = {
            "prompt": freq.prompt,
            "max_new_tokens": freq.max_new_tokens,
            "temperature": freq.temperature,
            "eos_id": freq.eos_id,
            "deadline_ms": max(1, int(freq.remaining_s() * 1e3)),
            "timeout_s": max(0.001, freq.remaining_s()),
            "trace_id": freq.id,
            "return_trace": True,
        }
        return _transport.post_json(
            self.host, self.port, "/v1/completions", payload,
            deadline=freq.deadline, retries=retries)

    def shutdown(self, drain=True, timeout=30):
        """Graceful stop: SIGTERM rides the replica's lifecycle drain
        (in-flight finishes, queued rejects cleanly); escalate to
        SIGKILL only past ``timeout``."""
        if self.proc.poll() is not None:
            return
        try:
            self.proc.send_signal(
                signal.SIGTERM if drain else signal.SIGKILL)
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            _LOGGER.warning("replica %s ignored SIGTERM for %ss; "
                            "killing", self.rid, timeout)
            self.proc.kill()
            self.proc.wait(timeout=5)

    def kill(self):
        """The chaos path: immediate SIGKILL, no drain, no goodbye."""
        if self.proc.poll() is None:
            self.proc.kill()


class FleetManager:
    """Owns the replica set.  Exactly one of ``spawn_cmd`` (process
    mode: ``spawn_cmd(rid) -> (argv, extra_env)``) or
    ``engine_factory`` (local mode: ``engine_factory(rid, donor) ->
    started engine``) must be given."""

    def __init__(self, spawn_cmd=None, engine_factory=None,
                 replicas=None, max_replicas=8, auto_heal=True,
                 ready_timeout_s=180.0, eject_threshold=None,
                 probe_interval_ms=None):
        if (spawn_cmd is None) == (engine_factory is None):
            raise MXNetError("FleetManager needs exactly one of "
                             "spawn_cmd / engine_factory")
        self._spawn_cmd = spawn_cmd
        self._engine_factory = engine_factory
        self.target_replicas = int(replicas) if replicas is not None \
            else _env.fleet_replicas()
        self.max_replicas = int(max_replicas)
        self.auto_heal = bool(auto_heal)
        self.ready_timeout_s = float(ready_timeout_s)
        self._eject_threshold = eject_threshold if eject_threshold \
            is not None else _env.fleet_eject_threshold()
        self._probe_interval_s = (
            probe_interval_ms if probe_interval_ms is not None
            else _env.fleet_probe_interval_ms()) / 1e3
        self.router = None            # attached by attach_router
        self._seq = 0
        self._lock = threading.Lock()
        self._stopping = False
        self.spawn_times: list = []   # (rid, kind, ready_seconds)

    def attach_router(self, router):
        self.router = router
        router._manager = self
        return self

    def _next_rid(self):
        with self._lock:
            self._seq += 1
            return f"replica-{self._seq}"

    # -- spawning ----------------------------------------------------------
    def spawn_replica(self, kind="initial", donor=None):
        """Bring one replica up (through the ``fleet.spawn`` seam,
        transient spawn failures retried) and register it with the
        router.  Returns the new handle."""
        rid = self._next_rid()
        t0 = time.monotonic()
        handle = _fault.call_with_retries(
            "fleet.spawn", self._spawn_one, rid, donor)
        dt = time.monotonic() - t0
        _C_SPAWNS.labels(kind=kind).inc()
        _H_SPAWN.observe(dt)
        with self._lock:
            self.spawn_times.append((rid, kind, dt))
        if self.router is not None:
            self.router.add_replica(handle)
        _LOGGER.info("fleet: %s %s ready in %.2fs", kind, rid, dt)
        return handle

    def _spawn_one(self, rid, donor):
        if self._engine_factory is not None:
            from .router import LocalReplica

            engine = self._engine_factory(rid, donor)
            return LocalReplica(
                rid, engine, eject_threshold=self._eject_threshold,
                probe_interval_s=self._probe_interval_s)
        argv, extra_env = self._spawn_cmd(rid)
        env = dict(os.environ)
        env.update(extra_env or {})
        proc = subprocess.Popen(
            argv, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        port = self._wait_ready(rid, proc)
        return ProcessReplica(
            rid, proc, "127.0.0.1", port,
            eject_threshold=self._eject_threshold,
            probe_interval_s=self._probe_interval_s)

    def _wait_ready(self, rid, proc):
        """Block until the child prints the engine ready banner; a
        child that dies or stalls first is a failed spawn (OSError →
        transient → the seam's retry policy takes it)."""
        deadline = time.monotonic() + self.ready_timeout_s
        # readline on a pipe has no timeout; a reader thread + join
        # bounds it without platform-specific select dances
        result: dict = {}

        def read():
            for line in proc.stdout:
                m = _READY_RE.search(line)
                if m:
                    result["port"] = int(m.group(1))
                    break
            # keep draining so the child never blocks on a full pipe
            for _ in proc.stdout:
                pass

        t = threading.Thread(target=read, daemon=True,
                             name=f"mxnet-fleet-ready-{rid}")
        t.start()
        while "port" not in result:
            if proc.poll() is not None:
                raise OSError(f"replica {rid} exited "
                              f"{proc.returncode} before ready")
            if time.monotonic() > deadline:
                proc.kill()
                raise OSError(f"replica {rid} not ready within "
                              f"{self.ready_timeout_s}s")
            time.sleep(0.05)
        return result["port"]

    def ensure(self, n=None, donor=None):
        """Spawn until the router has ``n`` (default target) replicas."""
        n = self.target_replicas if n is None else int(n)
        out = []
        while len(self.router.replicas()) < n:
            kind = "initial" if not self.router.replicas() or donor \
                is None else "scale_up"
            out.append(self.spawn_replica(kind=kind, donor=donor))
        return out

    # -- failure recovery --------------------------------------------------
    def on_replica_dead(self, replica):
        """Router callback (after it resubmitted the in-flight work):
        drop the corpse from rotation, reap it, and heal the fleet size
        with a replacement, asynchronously (spawning takes seconds and the
        dispatch plane must not wait on it).  Reaping closes a local
        replica's engine, whose handle may have died while the engine
        still runs (the ``replica.crash`` seam): its KV pool comes back
        before the replacement allocates one."""
        if self.router is not None:
            self.router.remove_replica(replica)

        def heal():
            try:
                replica.shutdown(drain=False, timeout=5)
            except Exception:
                _LOGGER.exception("fleet: reaping %s failed", replica.rid)
            # a stop request ends every engine loop: a replica seen dead
            # then is being drained, not replaced
            if not self.auto_heal or self._stopping or \
                    _lifecycle.stop_requested():
                return
            try:
                donor = self._pick_donor()
                self.spawn_replica(kind="replacement", donor=donor)
            except Exception:
                _LOGGER.exception("fleet: replacement spawn failed")

        threading.Thread(target=heal, daemon=True,
                         name="mxnet-fleet-heal").start()

    def _pick_donor(self):
        """A healthy LocalReplica engine whose params can be donated
        (join_replica); process mode has no donor."""
        from .health import HEALTHY
        from .router import LocalReplica

        if self.router is None:
            return None
        for r in self.router.replicas():
            if isinstance(r, LocalReplica) and r.alive() and \
                    r.health.state == HEALTHY:
                return r.engine
        return None

    # -- scaling (Autoscaler hooks) ----------------------------------------
    def scale_up(self, reason=""):
        if self._stopping or \
                len(self.router.replicas()) >= self.max_replicas:
            return None
        _LOGGER.info("fleet: scaling up (%s)", reason)
        return self.spawn_replica(kind="scale_up",
                                  donor=self._pick_donor())

    def scale_down(self, reason=""):
        """Retire ONE replica via the SIGTERM drain path: it finishes
        in-flight work, rejects queued work cleanly (the router holds
        the queue, so there is none replica-side), and exits."""
        reps = self.router.replicas()
        if self._stopping or len(reps) <= 1:
            return None
        # retire the least-loaded live replica
        victim = min(reps, key=lambda r: r.inflight_count())
        _LOGGER.info("fleet: scaling down %s (%s)", victim.rid, reason)
        self.router.remove_replica(victim)

        def drain():
            victim.shutdown(drain=True)

        threading.Thread(target=drain, daemon=True,
                         name="mxnet-fleet-drain").start()
        return victim

    def drain_all(self, timeout=60):
        """Fleet shutdown: SIGTERM-drain every replica in parallel."""
        self._stopping = True
        reps = self.router.replicas() if self.router is not None else []
        threads = []
        for r in reps:
            t = threading.Thread(target=r.shutdown,
                                 kwargs={"drain": True,
                                         "timeout": timeout},
                                 daemon=True)
            t.start()
            threads.append(t)
        for t in threads:
            t.join(timeout=timeout)
        for r in reps:
            if self.router is not None:
                self.router.remove_replica(r)


def serve_fleet(spawn_cmd=None, engine_factory=None, replicas=None,
                port=None, install_signals=True, on_ready=None,
                autoscale=False, **router_kw):
    """Blocking fleet entrypoint (the multi-replica analog of
    ``serving.serve``): spawn the replicas, start the router, mount
    the HTTP front door beside ``/metrics``, and run until a graceful
    stop.  SIGTERM drains every replica and returns
    ``lifecycle.EXIT_PREEMPTED``; ``on_ready(router, bound_port)``
    fires once the fleet is serving."""
    from .policy import Autoscaler

    lifecycle = _lifecycle
    if install_signals:
        lifecycle.install_signal_handlers()
    server = _telemetry.start_http_server(
        port if port is not None else (_env.serving_port() or 0))
    manager = FleetManager(spawn_cmd=spawn_cmd,
                           engine_factory=engine_factory,
                           replicas=replicas)
    router = Router(**router_kw)
    manager.attach_router(router)
    scaler = None
    if autoscale:
        scaler = Autoscaler(
            scale_up=manager.scale_up, scale_down=manager.scale_down,
            max_replicas=manager.max_replicas,
            replica_count=lambda: len(router.replicas()))
        router._autoscaler = scaler
    # the spawns are inside the drained region: a failure after the first
    # spawn must not leave its replica running
    try:
        manager.ensure()
        router.start()
        router.mount_http()
        bound = server.server_address[1]
        print(f"mxnet_tpu_torch fleet: router up on 127.0.0.1:{bound} with "
              f"{len(router.replicas())} replicas (/v1/completions, "
              f"/v1/fleet, /metrics)", flush=True)
        if on_ready is not None:
            on_ready(router, bound)
        while not lifecycle.stop_requested():
            time.sleep(0.1)
    finally:
        manager.drain_all()
        router.close()
    lifecycle.cancel_grace_deadline()
    return lifecycle.EXIT_PREEMPTED if lifecycle.stop_requested() else 0
