"""Comms ledger: per-op counts, sizes, latency and bandwidth.

Port of ``deepspeed_tpu/utils/comms_logging.py`` (reference ``CommsLogger``,
``deepspeed/utils/comms_logging.py:67``, and the ``timed_op`` wrapper of
``comm/comm.py:101``). Every collective of the port runs eagerly, so each
entry is timed on the host around the call (for NCCL that is the enqueue;
gloo returns when the exchange is done). Each entry keeps the LOGICAL
payload (what the exact collective would move) and the bytes that rode the
wire: compressed collectives report their int8 payload and scales there.
The comm planner's decisions land in ``plan_records`` (``record_plan``),
printed as the plan table by ``log_summary``; the JAX ledger's memory and
static-audit tables read compiled XLA programs and have no counterpart.

Every ``timed_op`` also appends one launch record to the collective flight
recorder (``telemetry/collective.py``) when a ``TelemetryManager`` turned
it on, ``shape`` being the payload's byte count: the port's collectives
run eagerly, so each record is a real launch.
"""

import time
from collections import defaultdict
from typing import Any, Dict, List, Optional

from ..telemetry.collective import record_launch


def get_msg_size(nbytes: int) -> str:
    for unit in ["B", "KB", "MB", "GB", "TB"]:
        if nbytes < 1024:
            return f"{nbytes:.2f} {unit}"
        nbytes /= 1024
    return f"{nbytes:.2f} PB"


def calc_bw(op_name: str, size_bytes: int, duration_s: float, n: int):
    """Algorithm and bus bandwidth in GB/s (NCCL-tests conventions, as the
    reference ``comms_logging.get_bw``)."""
    if duration_s <= 0:
        return 0.0, 0.0
    algbw = size_bytes / duration_s / 1e9
    if "all_to_all" in op_name or "all_gather" in op_name or "reduce_scatter" in op_name:
        busbw = algbw * ((n - 1) / n)
    elif "all_reduce" in op_name:
        busbw = algbw * (2 * (n - 1) / n)
    else:  # broadcast, barrier
        busbw = algbw
    return algbw, busbw


class CommsLogger:
    def __init__(self, enabled: bool = False, verbose: bool = False, debug: bool = False,
                 prof_all: bool = True, prof_ops: Optional[List[str]] = None):
        self.enabled = enabled
        self.verbose = verbose
        self.debug = debug
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        # op_name -> logical msg_size -> [count, total_latency_s, wire_bytes_total]
        self.comms_dict: Dict[str, Dict[int, List[float]]] = defaultdict(
            lambda: defaultdict(lambda: [0, 0.0, 0]))
        # link class ("ici" | "dcn" | "host") -> wire bytes, for callers that
        # tag their traffic with the link it rides
        self.hop_bytes: Dict[str, int] = defaultdict(int)
        # site signature -> planner decision info (comm/planner): per-mesh
        # facts, not per-step counters — reset() deliberately keeps them
        self.plan_records: Dict[str, Dict[str, Any]] = {}

    def configure(self, enabled=None, verbose=None, prof_all=None, prof_ops=None, debug=None):
        if enabled is not None:
            self.enabled = enabled
        if verbose is not None:
            self.verbose = verbose
        if prof_all is not None:
            self.prof_all = prof_all
        if prof_ops is not None:
            self.prof_ops = prof_ops
        if debug is not None:
            self.debug = debug

    def _should_log(self, op_name: str) -> bool:
        return self.enabled and (self.prof_all or op_name in self.prof_ops)

    def append(self, op_name: str, size_bytes: int, latency_s: float = 0.0,
               wire_bytes: Optional[int] = None, hop_class: Optional[str] = None):
        """``wire_bytes`` defaults to ``size_bytes`` (an exact collective
        moves what it carries)."""
        if not self._should_log(op_name):
            return
        wire = int(size_bytes if wire_bytes is None else wire_bytes)
        rec = self.comms_dict[op_name][int(size_bytes)]
        rec[0] += 1
        rec[1] += latency_s
        rec[2] += wire
        if hop_class is not None:
            self.hop_bytes[hop_class] += wire
        if self.verbose:
            from .logging import logger

            logger.info(f"comm op: {op_name} | size: {get_msg_size(size_bytes)} | "
                        f"{latency_s * 1e3:.2f} ms")

    def record_plan(self, signature: str, info: Dict[str, Any]) -> None:
        """Record one resolved planner decision (``comm/planner``). Stored
        unconditionally — plan facts are cheap and ``log_summary`` prints
        them as the plan table; unlike traffic rows they survive
        ``reset()`` (the plan is per-topology, not per-step)."""
        self.plan_records[signature] = dict(info)

    def plan_table_lines(self) -> List[str]:
        """The resolved-plan table (one row per site), empty when nothing
        has been recorded."""
        if not self.plan_records:
            return []
        header = (f"{'Consumer':<12}{'Op':<16}{'Shape':<18}"
                  f"{'Axes':<16}{'Impl':<14}{'Block':<8}{'Source':<12}"
                  f"{'Est(us)':<10}")
        lines = ["Collective plan:", header, "-" * len(header)]
        for sig in sorted(self.plan_records):
            r = self.plan_records[sig]
            lines.append(
                f"{r.get('consumer', '?'):<12}{r.get('op', '?'):<16}"
                f"{r.get('shape', '?'):<18}{r.get('axes', '?'):<16}"
                f"{r.get('impl', '?'):<14}{str(r.get('block') or '-'):<8}"
                f"{r.get('source', '?'):<12}"
                f"{str(r.get('est_us') if r.get('est_us') is not None else '-'):<10}"
                + (f" {r['program']}" if r.get("program") else ""))
        return lines

    def totals(self) -> Dict[str, Dict[str, Any]]:
        """op -> {count, bytes (logical), wire_bytes, total_latency_ms}."""
        out: Dict[str, Dict[str, Any]] = {}
        for op_name, sizes in self.comms_dict.items():
            count = byts = wire = 0
            lat = 0.0
            for size, rec in sizes.items():
                count += rec[0]
                byts += size * rec[0]
                lat += rec[1]
                wire += rec[2]
            out[op_name] = {"count": count, "bytes": byts, "wire_bytes": wire,
                            "total_latency_ms": lat * 1e3}
        return out

    def log_summary(self, world_size: int = 1, show_straggler: bool = False
                    ) -> Dict[str, Dict[str, Any]]:
        """Print the reference count/size/latency/bandwidth table and return
        :meth:`totals`."""
        header = (f"{'Comm op':<28}{'Message size':<16}{'Count':<8}{'Total lat(ms)':<15}"
                  f"{'Avg lat(ms)':<13}{'algbw(GB/s)':<13}{'busbw(GB/s)':<13}{'wire':<10}")
        lines = [header, "-" * len(header)]
        for op_name, sizes in sorted(self.comms_dict.items()):
            for size, (count, total_lat, wire) in sorted(sizes.items()):
                avg = total_lat / count if count else 0.0
                algbw, busbw = calc_bw(op_name, size, avg, world_size)
                logical = size * count
                ratio = f"{logical / wire:.2f}x" if wire and wire < logical else "1x"
                lines.append(f"{op_name:<28}{get_msg_size(size):<16}{count:<8}"
                             f"{total_lat * 1e3:<15.2f}{avg * 1e3:<13.3f}{algbw:<13.2f}"
                             f"{busbw:<13.2f}{ratio:<10}")
        plan = self.plan_table_lines()
        if plan:
            lines += [""] + plan
        print("\n".join(lines), flush=True)
        return self.totals()

    def hop_totals(self) -> Dict[str, int]:
        return dict(self.hop_bytes)

    def reset(self):
        self.comms_dict.clear()
        self.hop_bytes.clear()


class timed_op:
    """Context manager timing an eager collective into the ledger."""

    def __init__(self, ledger: CommsLogger, op_name: str, size_bytes: int,
                 wire_bytes: Optional[int] = None, hop_class: Optional[str] = None,
                 detail: Optional[str] = None):
        self.ledger = ledger
        self.op_name = op_name
        self.size_bytes = size_bytes
        self.wire_bytes = wire_bytes
        self.hop_class = hop_class
        self.detail = detail

    def __enter__(self):
        record_launch(self.op_name, shape=(int(self.size_bytes),), link=self.hop_class,
                      eager=True, detail=self.detail)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.ledger.append(self.op_name, self.size_bytes, time.perf_counter() - self.t0,
                           wire_bytes=self.wire_bytes, hop_class=self.hop_class)
        return False
