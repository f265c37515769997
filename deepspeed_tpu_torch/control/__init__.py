"""Control plane of the port: the supervisor's rule book, flap guard and
decision ledger, driven by the serving tier.

Port of ``deepspeed_tpu/control/``. The supervisor ticks from an
``LLMServer``'s engine thread (:meth:`ControlSupervisor.attach_server`);
every decision lands in the :class:`ControlLedger`. The winner cache
(``winners.py``) keys tuned knobs by mesh fingerprint; the fleet's warm
join reads it. The autotuner (``autotune.py``) needs ``autotuning/``:
looking one of its names up here raises ``NotImplementedError`` naming
ROADMAP.md Queue A item 9, as the training engine's wiring does.
"""

from .guard import FlapGuard
from .ledger import ControlAction, ControlLedger, describe_action
from .policy import POLICY_TABLE, RULE_NAMES
from .supervisor import ControlSupervisor
from .winners import WinnerCache, space_signature

_NOT_PORTED = dict.fromkeys(("ControlAutotuner", "build_space", "dim_candidates",
                             "probe_collective_programs"), "control/autotune.py")


def __getattr__(name):
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"{name} is not ported yet: ROADMAP.md Queue A item 9 "
            f"({_NOT_PORTED[name]})")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ControlSupervisor", "ControlLedger", "ControlAction", "FlapGuard",
           "describe_action", "POLICY_TABLE", "RULE_NAMES", "WinnerCache",
           "space_signature"]
