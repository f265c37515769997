"""Cross-host heartbeats: per-host beacons → dead-host / straggler verdicts.

Port of ``deepspeed_tpu/runtime/resilience/heartbeat.py``, host logic unchanged.

The watchdog (:mod:`watchdog`) notices *this* host's step not finishing; the
heartbeat table is the complementary fleet view — every host periodically
publishes a small beacon (rank, step, recent step time), and any reader can
derive:

- **dead host** — beacon older than ``dead_after_s`` (the host stopped
  publishing: wedged, preempted, or gone);
- **straggler** — a host whose reported step time exceeds ``factor`` × the
  fleet median (the pod failure mode where one slow host drags
  every collective; a straggler is *detectable* here long before the
  watchdog's absolute deadline trips).

Transport is pluggable via the two-method protocol of
:class:`FileHeartbeatTransport` (``write(rank, payload)`` /
``read_all() -> {rank: payload}``); the default is beacon files in a shared
directory (GCS-fuse / NFS on real pods, tmpdir in tests) written via
temp + ``os.replace`` so readers never observe a torn beacon.

Stdlib-only (no torch import): the
launcher and standalone drill scripts import it without touching a backend.
"""

import copy
import json
import os
import socket
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

try:
    from ...utils.logging import logger
except ImportError:  # loaded standalone (file-path import in drill scripts)
    import logging

    logger = logging.getLogger("deepspeed_tpu_torch.heartbeat")

try:
    from ...utils.retry import RetryError, RetryPolicy, retry_call
except ImportError:  # standalone load: degrade to single-attempt calls
    RetryError = OSError

    def retry_call(fn, **_kw):
        return fn()

    RetryPolicy = None

try:
    from .chaos import get_chaos
except ImportError:  # standalone load: chaos drills need the package

    def get_chaos():
        return None


# beacons are small and frequent: short backoffs, tight deadline — a PUT
# that cannot land within a couple of beacon intervals should fail (the
# beater retries next interval anyway)
_BEACON_RETRY = (RetryPolicy(max_attempts=4, base_s=0.02, cap_s=0.5,
                             deadline_s=5.0)
                 if RetryPolicy is not None else None)
# GETs ride synchronous read paths (HealthTable.read sits under the
# router's submit/alive_ids): immediate zero-backoff re-reads only — a
# sleeping per-key backoff on a degraded store would head-of-line block
# client traffic, and an absent beacon is already tolerated (the next
# periodic read retries naturally)
_BEACON_GET_RETRY = (RetryPolicy(max_attempts=3, base_s=0.0, cap_s=0.0,
                                 deadline_s=1.0)
                     if RetryPolicy is not None else None)

_BEACON_PREFIX = "hb-"


class FileHeartbeatTransport:
    """Beacon files ``hb-<rank>.json`` in a shared directory."""

    def __init__(self, directory: str):
        self.dir = os.path.abspath(directory)
        os.makedirs(self.dir, exist_ok=True)

    def write(self, rank: int, payload: dict) -> None:
        path = os.path.join(self.dir, f"{_BEACON_PREFIX}{int(rank)}.json")
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)  # readers see old-or-new, never torn

    def read_all(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        try:
            names = os.listdir(self.dir)
        except OSError:
            return out
        for name in names:
            if not (name.startswith(_BEACON_PREFIX) and name.endswith(".json")):
                continue
            try:
                rank = int(name[len(_BEACON_PREFIX):-len(".json")])
                with open(os.path.join(self.dir, name)) as f:
                    doc = json.load(f)
            except (ValueError, OSError, json.JSONDecodeError):
                continue  # partially-deleted or foreign file: not a beacon
            if isinstance(doc, dict):  # a torn/garbage body reads as absent
                out[rank] = doc
        return out


class _LocalBucketStub:
    """Minimal object-store client over a local directory, with BUCKET
    semantics: whole-object PUT/GET only (a reader never observes a partial
    write — PUT lands atomically), last-writer-wins per key, flat key
    namespace under a prefix. Stands in for a GCS/S3 bucket in tests and on
    dev boxes; a real deployment passes any client object with the same
    three methods (``put_object``/``get_object``/``list_objects``) to
    :class:`ObjectStoreHeartbeatTransport` instead."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _path(self, key: str) -> str:
        # keys are opaque bucket paths; map separators into the local tree
        safe = key.strip("/").replace("/", os.sep)
        return os.path.join(self.root, safe)

    def put_object(self, key: str, data: bytes) -> None:
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.put.{os.getpid()}"
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, path)  # the atomic whole-object PUT

    def get_object(self, key: str) -> bytes:
        try:
            with open(self._path(key), "rb") as f:
                return f.read()
        except OSError:
            raise KeyError(key)

    def list_objects(self, prefix: str):
        base = self._path(prefix)
        try:
            names = os.listdir(base)
        except OSError:
            return []
        pfx = prefix.strip("/")
        return [f"{pfx}/{n}" for n in sorted(names)
                if not n.split(os.sep)[-1].startswith(".")
                and ".put." not in n]


class ObjectStoreHeartbeatTransport:
    """The :class:`FileHeartbeatTransport` write/read_all protocol against a
    shared-bucket key/value layout (``<prefix>/hb-<rank>.json`` objects), so
    multi-slice fleets heartbeat through the object store they already have
    instead of needing a shared POSIX filesystem (slices rarely cross-mount
    one). Bucket contract: whole-object PUT/GET (no partial reads — a
    beacon decodes completely or reads as absent) and last-writer-wins per
    rank key (each rank owns its key; concurrent PUTs of the same key
    resolve to the newest, which is exactly beacon semantics).

    ``store`` is either a directory path (a :class:`_LocalBucketStub` is
    built over it) or any client exposing ``put_object(key, bytes)``,
    ``get_object(key) -> bytes`` and ``list_objects(prefix) -> [keys]``.

    Real buckets fail transiently (throttles, timeouts, 5xx): every PUT/GET
    runs under ``utils/retry.py`` (decorrelated-jitter backoff, deadline
    budget, ``dstpu_retry_total{site=heartbeat.*}``), so one EAGAIN never
    reads as a dead host. A beacon that decodes to garbage — a torn PUT
    observed mid-read on a store without whole-object semantics — reads as
    *absent*, never raises out of a :class:`HealthTable` refresh.
    """

    def __init__(self, store, prefix: str = "heartbeats",
                 retry: Optional["RetryPolicy"] = None,
                 get_retry: Optional["RetryPolicy"] = None):
        self.client = (_LocalBucketStub(store) if isinstance(store, str)
                       else store)
        self.prefix = prefix.strip("/")
        self.retry = retry or _BEACON_RETRY
        self.get_retry = get_retry or _BEACON_GET_RETRY

    def _key(self, rank: int) -> str:
        return f"{self.prefix}/{_BEACON_PREFIX}{int(rank)}.json"

    def write(self, rank: int, payload: dict) -> None:
        key = self._key(rank)
        data = json.dumps(payload).encode("utf-8")
        chaos = get_chaos()
        if chaos is not None:
            data = chaos.mangle_bytes("torn_beacon", "heartbeat.put", data)

        def _put():
            if chaos is not None:
                chaos.maybe_raise("transport_put_error", "heartbeat.put")
            self.client.put_object(key, data)

        retry_call(_put, site="heartbeat.put", policy=self.retry)

    def read_all(self) -> Dict[int, dict]:
        out: Dict[int, dict] = {}
        chaos = get_chaos()
        for key in self.client.list_objects(self.prefix):
            name = key.rsplit("/", 1)[-1]
            if not (name.startswith(_BEACON_PREFIX)
                    and name.endswith(".json")):
                continue

            def _get(key=key):
                if chaos is not None:
                    chaos.maybe_raise("transport_get_error", "heartbeat.get")
                return self.client.get_object(key)

            try:
                rank = int(name[len(_BEACON_PREFIX):-len(".json")])
                raw = retry_call(_get, site="heartbeat.get",
                                 policy=self.get_retry)
                doc = json.loads(raw)
            except (ValueError, KeyError, RetryError, OSError):
                # foreign object / deleted between list and get / retries
                # exhausted / torn or non-UTF-8 body: absent, not an error
                continue
            if isinstance(doc, dict):  # garbage-but-valid-JSON: absent too
                out[rank] = doc
        return out


class HeartbeatWriter:
    """Publishes this host's beacon. ``clock`` is injectable so tests can
    fabricate beacon ages deterministically."""

    def __init__(self, transport, rank: int,
                 clock: Callable[[], float] = time.time):
        self.transport = transport
        self.rank = int(rank)
        self.clock = clock
        self.beats = 0

    def beat(self, step: int, step_time_s: Optional[float] = None) -> None:
        self.transport.write(self.rank, {
            "rank": self.rank,
            "step": int(step),
            "step_time_s": None if step_time_s is None else float(step_time_s),
            "wall_time": float(self.clock()),
            "pid": os.getpid(),
            "host": socket.gethostname(),
        })
        self.beats += 1


@dataclass
class HostHealth:
    """One row of the fleet health table."""
    rank: int
    step: int
    step_time_s: Optional[float]
    age_s: float
    alive: bool
    straggler: bool
    ratio: float  # step_time / fleet median (1.0 when undefined)


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    n = len(xs)
    return xs[n // 2] if n % 2 else 0.5 * (xs[n // 2 - 1] + xs[n // 2])


class HealthTable:
    """Derives per-host verdicts from the beacon set.

    A host is a straggler only relative to *peers*: each host is compared
    against the median of the OTHER live hosts' step times (leave-one-out —
    an all-hosts median would let a 2-host fleet's straggler drag the
    reference up and cap its own ratio below 2×, making the verdict
    unreachable). With no live peer reporting a step time there is no
    reference and no straggler verdict.
    """

    def __init__(self, transport, *, dead_after_s: float = 60.0,
                 straggler_factor: float = 3.0,
                 clock: Callable[[], float] = time.time):
        self.transport = transport
        self.dead_after_s = float(dead_after_s)
        self.straggler_factor = float(straggler_factor)
        self.clock = clock
        self._last_rows: Optional[List[HostHealth]] = None  # chaos staleness

    def read(self) -> List[HostHealth]:
        chaos = get_chaos()
        if chaos is not None and chaos.fire("stale_health", "health.read"):
            # control-layer drill: this refresh returns the PREVIOUS rows
            # (a reader seeing stale data); consumers' flap guards must
            # ride it out instead of acting on one stale verdict. On a
            # first-ever read the previous state is the pre-warm-up empty
            # view — injecting that (rather than skipping but still
            # auditing the event) keeps the fired trail truthful.
            return copy.deepcopy(self._last_rows) if self._last_rows \
                else []
        beacons = self.transport.read_all()
        now = self.clock()
        rows: List[HostHealth] = []
        for rank in sorted(beacons):
            b = beacons[rank]
            age = max(0.0, now - float(b.get("wall_time", 0.0)))
            alive = age <= self.dead_after_s
            st = b.get("step_time_s")
            rows.append(HostHealth(rank=rank, step=int(b.get("step", -1)),
                                   step_time_s=st, age_s=age, alive=alive,
                                   straggler=False, ratio=1.0))
        reporting = [r for r in rows if r.alive and r.step_time_s is not None]
        if len(reporting) >= 2:
            for row in reporting:
                peers = [float(r.step_time_s) for r in reporting if r is not row]
                ref = _median(peers)
                if ref > 0:
                    row.ratio = float(row.step_time_s) / ref
                    row.straggler = row.ratio > self.straggler_factor
        if chaos is not None:
            ev = chaos.poll("flap_straggler", "health.read")
            if ev is not None and (ev.count - ev.remaining) % 2 == 1:
                # flapping signal: the target rank reads as a straggler on
                # alternate refreshes — the supervisor's trigger/clear
                # streaks must absorb it instead of re-planning every flap
                for row in rows:
                    if row.rank == int(ev.param):
                        row.straggler = True
                        row.ratio = max(row.ratio,
                                        self.straggler_factor + 1.0)
        self._last_rows = rows
        return rows

    def verdicts(self) -> Dict[str, List[int]]:
        """Condensed view: ``{"dead": [ranks], "stragglers": [ranks]}``."""
        rows = self.read()
        return {"dead": [r.rank for r in rows if not r.alive],
                "stragglers": [r.rank for r in rows if r.straggler]}
