"""Per-tenant SLA classes for the serving fleet.

Port of ``deepspeed_tpu/fleet/tenancy.py``, host logic unchanged.

Reference shape: DeepSpeed-MII deployments front one engine for many
callers; production fleets stratify those callers into service classes
(think gold / silver / bronze) so that, under contention, the cheap
traffic degrades first. This module is the ONE place that vocabulary
lives — the deadline scheduler, the server's admission door, and the
telemetry exporter all consume it through two small types:

- :class:`SLAClass` — a named class with an admission ``weight`` (higher
  = more important) and an optional default ``deadline_s`` stamped onto
  requests that arrive without one.
- :class:`TenancyMap` — tenant name → class, plus the default class for
  unmapped tenants (and for requests with no tenant at all).

Semantics (all derived from ``weight``, so one knob orders every layer
consistently):

admission order
    the deadline scheduler ranks by *weighted* deadline —
    ``arrival + deadline_s / weight`` — so a gold request with the same
    nominal deadline as a bronze one sorts ahead of it, and preemption
    victims (max by key) are the low-weight tenants first.

shed order
    the server's control-plane door (``control_max_queue``) scales per
    tenant: class c sheds at ``max(1, floor(watermark * w_c / w_max))``.
    As the supervisor halves the watermark under SLA pressure, bronze
    hits its (smaller) door first and gold keeps landing — low classes
    shed first, by construction.

identity across replicas
    the tenant rides ``Request.tenant`` itself, so router requeues after
    a replica loss land on the new replica with the same class applied.

The serving modules never import this package (they duck-type the map),
so tenancy stays optional: every path behaves exactly as before when no
``TenancyMap`` is installed.
"""

from dataclasses import dataclass
from typing import Any, Dict, Iterable, Mapping, Optional, Union

__all__ = ["SLAClass", "TenancyMap", "DEFAULT_CLASSES"]


@dataclass(frozen=True)
class SLAClass:
    """One service class: admission weight + optional default deadline."""
    name: str
    weight: float = 1.0                 # > 0; higher = admitted/kept first
    deadline_s: Optional[float] = None  # default SLA stamped when absent

    def __post_init__(self):
        if self.weight <= 0:
            raise ValueError(f"SLA class {self.name!r}: weight must be > 0")
        if self.deadline_s is not None and self.deadline_s <= 0:
            raise ValueError(f"SLA class {self.name!r}: deadline_s must be > 0")


#: the conventional three-class ladder used when a config names tenants
#: but no classes of its own
DEFAULT_CLASSES = (
    SLAClass("gold", weight=4.0),
    SLAClass("silver", weight=2.0),
    SLAClass("bronze", weight=1.0),
)


class TenancyMap:
    """Tenant → :class:`SLAClass` resolution, with a default class.

    ``tenants`` maps tenant names to class names; a tenant may also name
    a class directly (so tiny configs can skip the indirection). Unknown
    tenants — and requests with ``tenant=None`` — get the default class.
    """

    def __init__(self, classes: Iterable[SLAClass] = DEFAULT_CLASSES, *,
                 tenants: Optional[Mapping[str, str]] = None,
                 default: Optional[str] = None):
        self.classes: Dict[str, SLAClass] = {}
        for cls in classes:
            if cls.name in self.classes:
                raise ValueError(f"duplicate SLA class {cls.name!r}")
            self.classes[cls.name] = cls
        if not self.classes:
            raise ValueError("TenancyMap needs at least one SLA class")
        self.tenants: Dict[str, str] = dict(tenants or {})
        for tname, cname in self.tenants.items():
            if cname not in self.classes:
                raise ValueError(f"tenant {tname!r} maps to unknown "
                                 f"SLA class {cname!r}")
        if default is None:
            # lowest-weight class: unmapped traffic is best-effort
            default = min(self.classes.values(),
                          key=lambda c: (c.weight, c.name)).name
        if default not in self.classes:
            raise ValueError(f"unknown default SLA class {default!r}")
        self.default = default
        self.max_weight = max(c.weight for c in self.classes.values())

    # -- resolution ---------------------------------------------------------
    def cls_for(self, tenant: Optional[str]) -> SLAClass:
        if tenant is not None:
            cname = self.tenants.get(tenant)
            if cname is not None:
                return self.classes[cname]
            if tenant in self.classes:   # tenant named a class directly
                return self.classes[tenant]
        return self.classes[self.default]

    def weight(self, tenant: Optional[str]) -> float:
        return self.cls_for(tenant).weight

    def default_deadline_s(self, tenant: Optional[str]) -> Optional[float]:
        return self.cls_for(tenant).deadline_s

    # -- scheduler hook -----------------------------------------------------
    def effective_deadline_time(self, resp) -> Optional[float]:
        """The *weighted* deadline the scheduler sorts by:
        ``arrival + deadline_s / weight``. Dividing the budget by the
        class weight pulls high classes earlier in EDF order without
        touching the real (unweighted) SLA clock the metrics judge."""
        d = resp.request.deadline_s
        if d is None:
            return None
        w = self.weight(getattr(resp.request, "tenant", None))
        return resp.arrival_time + d / w

    # -- admission-door hook ------------------------------------------------
    def shed_watermark(self, base: int, tenant: Optional[str]) -> int:
        """Per-tenant control-plane shed door: the fraction of the base
        watermark this tenant's class may fill before being shed. Never
        below 1 — even bronze gets through an empty queue."""
        frac = self.weight(tenant) / self.max_weight
        return max(1, int(base * frac))

    # -- config -------------------------------------------------------------
    @classmethod
    def from_config(cls, spec: Union[None, "TenancyMap", Mapping[str, Any]]
                    ) -> Optional["TenancyMap"]:
        """Build from a ServingConfig ``tenancy`` dict::

            {"classes": {"gold": {"weight": 4, "deadline_s": 2.0},
                         "bronze": 1.0},          # shorthand: weight only
             "tenants": {"acme": "gold", "hobby": "bronze"},
             "default": "bronze"}

        ``classes`` omitted → the gold/silver/bronze DEFAULT_CLASSES.
        Returns None for a None spec (tenancy off); passes an existing
        TenancyMap through unchanged."""
        if spec is None:
            return None
        if isinstance(spec, cls):
            return spec
        raw = dict(spec)
        classes: Iterable[SLAClass]
        if "classes" in raw:
            classes = []
            for name, body in raw["classes"].items():
                if isinstance(body, Mapping):
                    classes.append(SLAClass(name,
                                            weight=float(body.get("weight", 1.0)),
                                            deadline_s=body.get("deadline_s")))
                else:                     # shorthand: weight scalar
                    classes.append(SLAClass(name, weight=float(body)))
        else:
            classes = DEFAULT_CLASSES
        return cls(classes, tenants=raw.get("tenants"),
                   default=raw.get("default"))

    def describe(self) -> Dict[str, Any]:
        """Loggable summary (ledger params / flight dumps)."""
        return {
            "classes": {c.name: {"weight": c.weight, "deadline_s": c.deadline_s}
                        for c in self.classes.values()},
            "tenants": dict(self.tenants),
            "default": self.default,
        }

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"TenancyMap(classes={sorted(self.classes)}, "
                f"tenants={len(self.tenants)}, default={self.default!r})")
