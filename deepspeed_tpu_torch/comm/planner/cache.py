"""On-disk plan cache: tuning runs once per topology.

Port of ``deepspeed_tpu/comm/planner/cache.py``, whole. One JSON file per
mesh fingerprint digest (``plan_<digest>.json``), holding the fingerprint
(human-readable provenance) and the site->decision map. The default
location is the port's own ``~/.cache/deepspeed_tpu_torch/comm_plans``
(the JAX package keeps ``~/.cache/deepspeed_tpu/comm_plans``: the two
packages' fingerprints differ, so their plans never mix), overridable via
the same ``DSTPU_PLAN_CACHE`` or the ``comm_planner.cache_dir`` config
knob. Writes
are atomic (tmp + rename) and merge with what is already on disk, so
concurrent jobs on the same topology only add sites, never lose them.
"""

import json
import os
import tempfile
from typing import Optional

from ...runtime.resilience.chaos import get_chaos
from ...utils.retry import RetryError, RetryPolicy, retry_call
from .ir import Plan
from .topo import MeshFingerprint

_ENV_VAR = "DSTPU_PLAN_CACHE"

# cache reads sit on the engine-build path: short backoffs, tight deadline —
# a shared-FS hiccup should not cost a re-tune, but a dead mount must
# degrade to a miss quickly (the planner just re-tunes)
_READ_RETRY = RetryPolicy(max_attempts=4, base_s=0.02, cap_s=0.5,
                          deadline_s=5.0)


def default_cache_dir() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "deepspeed_tpu_torch", "comm_plans")


class PlanCache:
    def __init__(self, cache_dir: Optional[str] = None,
                 space_version: Optional[int] = None):
        self.cache_dir = cache_dir or default_cache_dir()
        # search-space version (``compiler.SEARCH_SPACE``): part of the
        # cache identity. A winner is only the argmin OVER THE SPACE IT WAS
        # SEARCHED IN — widening the program grammar must read as a clean
        # miss (re-tune), never replay a stale narrower-space winner. None
        # keeps the legacy unversioned filename (pre-compiler callers).
        self.space_version = (None if space_version is None
                              else int(space_version))

    def path_for(self, fp: MeshFingerprint) -> str:
        tag = ("" if self.space_version is None
               else f"_s{self.space_version}")
        return os.path.join(self.cache_dir, f"plan_{fp.digest()}{tag}.json")

    def load(self, fp: MeshFingerprint) -> Optional[Plan]:
        """The cached plan for this fingerprint, or None. A corrupt or
        foreign-format file reads as a miss, never an error — the planner
        just re-tunes and overwrites it. Transient read errors (shared-FS
        hiccups) retry under the shared backoff first (``dstpu_retry_total
        {site=plan_cache.load}``); an absent file is an immediate miss.

        A version-carrying cache also falls back to the LEGACY unversioned
        filename: a pre-compiler plan file has no search-space identity and
        migrates on read (same precedent as the unstamped-format
        migration), while a file stamped with a DIFFERENT version — the
        case the versioning exists for — stays a miss."""
        plan = self._load_path(self.path_for(fp), fp)
        if plan is None and self.space_version is not None:
            legacy = os.path.join(self.cache_dir,
                                  f"plan_{fp.digest()}.json")
            plan = self._load_path(legacy, fp)
        return plan

    def _load_path(self, path: str, fp: MeshFingerprint) -> Optional[Plan]:
        chaos = get_chaos()

        def _read():
            if chaos is not None:
                chaos.maybe_raise("plan_cache_error", "plan_cache.load")
            with open(path) as f:
                return f.read()

        try:
            body = retry_call(_read, site="plan_cache.load",
                              policy=_READ_RETRY)
            plan = Plan.from_dict(json.loads(body))
        except (RetryError, OSError, ValueError, KeyError, TypeError):
            return None
        if self.space_version is not None:
            # belt + braces beside the filename tag: a copied/renamed file
            # from another search-space version still reads as a miss (an
            # UNSTAMPED body is legacy and migrates)
            try:
                stamped = json.loads(body).get("search_space")
            except ValueError:
                return None
            if stamped is not None and int(stamped) != self.space_version:
                return None
        return plan if plan.fingerprint == fp.digest() else None

    def store(self, fp: MeshFingerprint, plan: Plan) -> str:
        """Merge ``plan`` into the on-disk plan for ``fp`` (new decisions
        win) and write atomically. An exclusive flock serializes the whole
        read-merge-write against concurrent writers (two jobs on a shared
        home dir) so neither can drop the other's decisions; tmp+rename
        additionally keeps readers from ever seeing a torn file. Returns
        the file path."""
        os.makedirs(self.cache_dir, exist_ok=True)
        path = self.path_for(fp)
        lock = open(path + ".lock", "w")
        try:
            try:
                import fcntl

                fcntl.flock(lock, fcntl.LOCK_EX)
            except (ImportError, OSError):
                pass  # no flock (non-POSIX / odd FS): best-effort merge
            merged = self.load(fp) or Plan(fingerprint=fp.digest())
            merged.decisions.update(plan.decisions)
            body = {"fingerprint": fp.digest(), "mesh": fp.to_dict(),
                    **merged.to_dict()}
            if self.space_version is not None:
                body["search_space"] = self.space_version
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
