"""Autotuner winner cache: tuned knobs keyed by mesh fingerprint digest.

Port of ``deepspeed_tpu/control/winners.py``, whole. Tuning is only worth
its probe budget if it runs ONCE per topology. The winner cache lives
beside the comm-plan cache (same directory resolution:
``comm_planner.cache_dir`` > ``$DSTPU_PLAN_CACHE`` >
``~/.cache/deepspeed_tpu_torch/comm_plans``) as ``autotune_<digest>.json``,
one file per :class:`~deepspeed_tpu_torch.comm.planner.topo.MeshFingerprint`
digest (the card's name is part of it) —
so a changed mesh (different chip count, different axis split, a forced
DCN override) can NEVER replay a stale winner, and a cold restart on the
same mesh reuses the recorded winner without a single probe.

Inside one mesh's file, winners are keyed by a *space signature* — a hash
of the searched dimensions, their candidate names, and the metric — so
re-tuning with a different search space records a sibling entry instead of
clobbering (or wrongly satisfying) the old one.

Writes use the plan cache's discipline: flock-serialized read-merge-write,
tmp + atomic rename. A corrupt or foreign file reads as a miss.
"""

import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Optional

from ..comm.planner.cache import default_cache_dir
from ..comm.planner.topo import MeshFingerprint

_FILE_VERSION = 1


def space_signature(dims: Dict[str, Any], metric: str) -> str:
    """Stable hash of the searched space: dimension names + the candidate
    names inside each + the optimization metric."""
    blob = json.dumps({"dims": {k: sorted(v) if isinstance(v, (list, tuple))
                                else v for k, v in sorted(dims.items())},
                       "metric": metric}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


class WinnerCache:
    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir or default_cache_dir()

    def path_for(self, fp: MeshFingerprint) -> str:
        return os.path.join(self.cache_dir, f"autotune_{fp.digest()}.json")

    def _read(self, fp: MeshFingerprint) -> Dict[str, Any]:
        try:
            with open(self.path_for(fp)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return {}
        if not isinstance(doc, dict) or doc.get("fingerprint") != fp.digest():
            return {}
        winners = doc.get("winners")
        return winners if isinstance(winners, dict) else {}

    # ------------------------------------------------------------------
    def lookup(self, fp: MeshFingerprint, space_sig: str
               ) -> Optional[Dict[str, Any]]:
        """The recorded winner for (mesh digest, search space), or None."""
        w = self._read(fp).get(space_sig)
        return dict(w) if isinstance(w, dict) else None

    def store(self, fp: MeshFingerprint, space_sig: str,
              winner: Dict[str, Any]) -> str:
        """Merge one winner in (flock + tmp/rename, the PlanCache recipe)
        and return the file path."""
        os.makedirs(self.cache_dir, exist_ok=True)
        path = self.path_for(fp)
        lock = open(path + ".lock", "w")
        try:
            try:
                import fcntl

                fcntl.flock(lock, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # no flock: best-effort merge
            winners = self._read(fp)
            winners[space_sig] = {**winner, "recorded_wall_time": time.time()}
            body = {"version": _FILE_VERSION, "fingerprint": fp.digest(),
                    "mesh": fp.to_dict(), "winners": winners}
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    json.dump(body, f, indent=1, sort_keys=True)
                os.replace(tmp, path)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        finally:
            lock.close()
        return path
