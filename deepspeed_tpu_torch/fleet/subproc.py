"""Subprocess-backed replicas behind the in-process server protocol.

Port of ``deepspeed_tpu/fleet/subproc.py``, whole, with the JAX package's
newline-JSON protocol (``hello``, ``submit``, ``reject``, ``done``,
``drain``, ``drained``, ``halt``). The child's standard output is the
protocol channel and nothing else: the worker moves file descriptor 1 to
its standard error before it builds anything, so logging, kernel build
messages and warnings never reach the parent's reader. The parent puts the
directory that holds ``deepspeed_tpu_torch`` on the child's ``PYTHONPATH``,
so the worker module resolves from a fresh interpreter wherever it runs;
a factory module elsewhere needs its own directory there too.

The lifecycle's ``factory(replica_id)`` normally builds an in-process
``LLMServer`` (one engine per replica — tier-1's shape). A real fleet
runs each replica in its OWN process; this module is that path without
changing a line of router/lifecycle code:

- :func:`worker_main` — the child: builds a server from a dotted
  ``module:callable`` factory, warms it (so ``hello`` implies warm),
  then serves newline-JSON ops (``submit`` / ``drain`` / ``halt``) on
  stdin and streams ``done`` completions on stdout.
- :class:`SubprocessReplica` — the parent-side proxy implementing the
  protocol surface the router and lifecycle touch: ``replica_id``,
  ``warmed``, ``error``, ``outstanding``, ``metrics``, ``submit``,
  ``start``/``drain``/``halt``/``steal_unfinished``, and ``_thread``
  (always None — the router's liveness checks treat a process with no
  engine thread as conclusively stopped, which for a killed child is
  exactly right).

Liveness rides the SAME beacon protocol as in-process replicas: pass
``heartbeat_dir`` and the CHILD writes ``FileHeartbeatTransport``
beacons — the parent router reads the shared directory, so a killed
child goes stale and the dead-replica takeover requeues its work with
no proxy-side special case.

Streaming tokens are not proxied (completions land whole); everything
the router's requeue/SLA machinery needs — tokens, finish reason,
latency stamps — is.

Run a worker directly:  ``python -m deepspeed_tpu_torch.fleet.subproc \\
--factory pkg.mod:make_server --replica-id 3 --heartbeat-dir /tmp/hb``
"""

import json
import os
import subprocess
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..serving.metrics import ServingMetrics
from ..serving.request import (FINISH_FAILED, Request, ServedResponse)
from ..serving.server import ServerClosed, ServerOverloaded
from ..utils.logging import logger

_ENC = dict(separators=(",", ":"))


def _send(stream, msg: Dict[str, Any]) -> None:
    stream.write(json.dumps(msg, **_ENC) + "\n")
    stream.flush()


# ---------------------------------------------------------------------------
# child side
# ---------------------------------------------------------------------------
def _resolve_factory(spec: str) -> Callable[[int], Any]:
    """``module.path:callable`` → the callable."""
    mod_name, _, attr = spec.partition(":")
    if not attr:
        raise ValueError(f"factory spec {spec!r} must be 'module:callable'")
    import importlib

    fn = importlib.import_module(mod_name)
    for part in attr.split("."):
        fn = getattr(fn, part)
    return fn


def _protocol_stdout():
    """A text stream on the process's original standard output, with file
    descriptor 1 (and ``sys.stdout``) moved to standard error: whatever the
    server's build prints, from Python or from a child process, lands
    there and never in the protocol channel."""
    sys.stdout.flush()
    proto = os.fdopen(os.dup(1), "w", buffering=1)
    os.dup2(2, 1)
    sys.stdout = sys.stderr
    return proto


def worker_main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="deepspeed_tpu_torch.fleet.subproc")
    ap.add_argument("--factory", required=True,
                    help="module:callable building the LLMServer")
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--heartbeat-dir", default=None)
    args = ap.parse_args(argv)
    out = _protocol_stdout()

    server = _resolve_factory(args.factory)(args.replica_id)
    if args.heartbeat_dir:
        from ..runtime.resilience.heartbeat import (FileHeartbeatTransport,
                                                    HeartbeatWriter)

        server.heartbeat = HeartbeatWriter(
            FileHeartbeatTransport(args.heartbeat_dir), rank=args.replica_id)
    # warm before hello: the parent's lifecycle treats hello as "warmed"
    from .lifecycle import ReplicaHandle

    handle = ReplicaHandle(args.replica_id, lambda rid: server)
    handle.spawn()
    report = handle.warm()
    server.start()
    _send(out, {"op": "hello", "replica_id": args.replica_id,
                "warm": report.to_params()})

    pending: Dict[int, Any] = {}
    lock = threading.Lock()

    def pump():
        while True:
            with lock:
                finished = [(i, r) for i, r in pending.items() if r.done]
                for i, _ in finished:
                    del pending[i]
            for i, resp in finished:
                _send(out, {"op": "done", "id": i,
                            "tokens": [int(t) for t in resp.tokens],
                            "reason": resp.finish_reason,
                            "ttft_s": resp.ttft_s, "e2e_s": resp.e2e_s})
            time.sleep(0.005)

    threading.Thread(target=pump, daemon=True, name="subproc-pump").start()

    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue
        msg = json.loads(line)
        op = msg.get("op")
        if op == "submit":
            req = Request(np.asarray(msg["prompt"], np.int32),
                          max_new_tokens=int(msg.get("max_new_tokens", 64)),
                          eos_token_id=msg.get("eos_token_id"),
                          priority=int(msg.get("priority", 0)),
                          deadline_s=msg.get("deadline_s"),
                          request_id=msg.get("request_id"),
                          tenant=msg.get("tenant"))
            try:
                resp = server.submit(req, block=bool(msg.get("block", False)))
            except (ServerOverloaded, ServerClosed) as e:
                _send(out, {"op": "reject", "id": msg["id"],
                            "kind": type(e).__name__, "error": str(e)})
                continue
            with lock:
                pending[msg["id"]] = resp
        elif op == "drain":
            ok = server.drain(msg.get("timeout"))
            time.sleep(0.05)   # let the pump flush the last completions
            _send(out, {"op": "drained", "ok": bool(ok)})
            return 0
        elif op == "halt":
            server.halt()
            return 0
    server.halt()
    return 0


# ---------------------------------------------------------------------------
# parent side
# ---------------------------------------------------------------------------
class SubprocessReplica:
    """Router-protocol proxy for a replica living in a child process."""

    def __init__(self, replica_id: int, factory_spec: str, *,
                 heartbeat_dir: Optional[str] = None,
                 python: Optional[str] = None,
                 hello_timeout_s: float = 600.0,
                 clock: Callable[[], float] = time.monotonic):
        self.replica_id = int(replica_id)
        self.clock = clock
        self.metrics = ServingMetrics(clock=clock)
        self.heartbeat = None       # the CHILD beats; the router only reads
        self.error: Optional[BaseException] = None
        self.warmed = False
        self.fused_decode_chunk = 0   # tuned child-side during its warm
        self.warm_params: Dict[str, str] = {}
        self._thread = None         # no parent-side engine thread, ever
        self._accepting = True
        self._lock = threading.Lock()
        self._pending: Dict[int, ServedResponse] = {}
        self._next_id = 0
        cmd = [python or sys.executable, "-m",
               "deepspeed_tpu_torch.fleet.subproc",
               "--factory", factory_spec, "--replica-id", str(self.replica_id)]
        if heartbeat_dir:
            cmd += ["--heartbeat-dir", heartbeat_dir]
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                      if p and p != root])
        self.proc = subprocess.Popen(cmd, stdin=subprocess.PIPE,
                                     stdout=subprocess.PIPE, text=True,
                                     bufsize=1, env=env)
        self._hello = threading.Event()
        self._reader = threading.Thread(target=self._read_loop, daemon=True,
                                        name=f"subproc-read-{replica_id}")
        self._reader.start()
        if not self._hello.wait(hello_timeout_s):
            self.proc.kill()
            raise RuntimeError(f"subprocess replica {replica_id}: no hello "
                               f"within {hello_timeout_s}s")

    # -- protocol surface ---------------------------------------------------
    @property
    def outstanding(self) -> int:
        with self._lock:
            return len(self._pending)

    def start(self):
        return self

    def submit(self, request: Request, *, block: bool = False,
               timeout: Optional[float] = None,
               _response: Optional[ServedResponse] = None) -> ServedResponse:
        with self._lock:
            if not self._accepting or self.proc.poll() is not None:
                raise ServerClosed(
                    f"subprocess replica {self.replica_id} is not accepting")
            mid = self._next_id
            self._next_id += 1
            if _response is None:
                resp = ServedResponse(request, mid, self.clock())
            else:
                resp = _response
                resp.uid = mid
                self.metrics.requeues += 1
            resp.replica_id = self.replica_id
            self._pending[mid] = resp
        try:
            _send(self.proc.stdin, {
                "op": "submit", "id": mid,
                "prompt": [int(t) for t in resp.engine_prompt()],
                "max_new_tokens": resp.remaining_new_tokens(),
                "eos_token_id": request.eos_token_id,
                "priority": request.priority,
                "deadline_s": request.deadline_s,
                "request_id": request.request_id,
                "tenant": getattr(request, "tenant", None),
                "block": bool(block),
            })
        except (BrokenPipeError, OSError) as e:
            with self._lock:
                self._pending.pop(mid, None)
            raise ServerClosed(
                f"subprocess replica {self.replica_id} pipe closed") from e
        self.metrics.on_submit(resp)
        return resp

    def _read_loop(self) -> None:
        try:
            for line in self.proc.stdout:
                msg = json.loads(line)
                op = msg.get("op")
                if op == "hello":
                    self.warm_params = msg.get("warm", {})
                    self.warmed = True
                    self._hello.set()
                elif op == "done":
                    self._on_done(msg)
                elif op == "reject":
                    self._on_reject(msg)
                elif op == "drained":
                    self._drained = bool(msg.get("ok"))
        except Exception as e:  # noqa: BLE001 - a dead pipe ends the loop
            logger.warning(f"fleet: subprocess replica {self.replica_id} "
                           f"reader stopped: {e!r}")

    def _on_done(self, msg: Dict[str, Any]) -> None:
        with self._lock:
            resp = self._pending.pop(msg["id"], None)
        if resp is None or resp.done:
            return
        now = self.clock()
        # replay the child's lifecycle onto the handle; latency stamps are
        # reconstructed so ttft_s/e2e_s read the child's own measurements
        for tok in msg.get("tokens", [])[len(resp.tokens):]:
            resp._on_token(int(tok), now)
        if msg.get("ttft_s") is not None and resp.tokens:
            resp.first_token_time = resp.arrival_time + float(msg["ttft_s"])
        resp._on_finish(msg.get("reason") or FINISH_FAILED, now)
        if msg.get("e2e_s") is not None:
            resp.finish_time = resp.arrival_time + float(msg["e2e_s"])
        self.metrics.on_finish(resp)

    def _on_reject(self, msg: Dict[str, Any]) -> None:
        with self._lock:
            resp = self._pending.pop(msg["id"], None)
        if resp is not None and not resp.done:
            self.metrics.on_reject(resp)
            resp._on_finish(FINISH_FAILED, self.clock())
            self.metrics.on_finish(resp)

    # -- lifecycle ----------------------------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        with self._lock:
            self._accepting = False
        try:
            _send(self.proc.stdin, {"op": "drain", "timeout": timeout})
        except (BrokenPipeError, OSError):
            return False
        try:
            self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            return False
        deadline = self.clock() + 5.0
        while self.outstanding and self.clock() < deadline:
            time.sleep(0.01)    # reader thread is landing the last dones
        return not self.outstanding

    def halt(self) -> None:
        with self._lock:
            self._accepting = False
        try:
            _send(self.proc.stdin, {"op": "halt"})
            self.proc.wait(2.0)
        except Exception:
            pass  # swallow-ok: an unresponsive child is killed below
        if self.proc.poll() is None:
            self.proc.kill()

    def steal_unfinished(self) -> List[ServedResponse]:
        if self.proc.poll() is None:
            raise RuntimeError("steal_unfinished on a live subprocess "
                               "replica (halt() it first)")
        with self._lock:
            out = [r for r in self._pending.values() if not r.done]
            self._pending.clear()
        return out

    def __repr__(self):  # pragma: no cover - debugging aid
        alive = self.proc.poll() is None
        return (f"SubprocessReplica(replica={self.replica_id}, "
                f"alive={alive}, outstanding={self.outstanding})")


if __name__ == "__main__":   # pragma: no cover - exercised via subprocess
    sys.exit(worker_main())
