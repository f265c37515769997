"""Fleet-wide training fast-path knobs: attention / loss / embedding.

Port of ``deepspeed_tpu/ops/fastpath.py``: ``initialize()`` maps the
``training_fastpath`` config block onto this module, and the model wiring
(``models/transformer.py``, ``sequence/cross_entropy.py``) reads it whenever
the model-level field is left at ``auto``. Resolution order at every site:

  model config field (non-auto) > fleet knob (non-auto) > auto heuristic

where the auto heuristic is per-site: the flash kernel when the tensors lie
on the card and the shape is eligible, the plain PyTorch path elsewhere.
"""

from typing import Dict

__all__ = ["configure_fastpath", "fastpath", "reset_fastpath"]

_VALID: Dict[str, tuple] = {
    "attn_impl": ("auto", "xla", "flash"),
    "loss_impl": ("auto", "xla", "fused"),
    "embedding_overlap": ("auto", "xla", "ring"),
}

_DEFAULTS = {k: "auto" for k in _VALID}
_STATE = dict(_DEFAULTS)


def configure_fastpath(**knobs: str) -> Dict[str, str]:
    """Set fleet-wide fast-path defaults; unknown keys / members raise."""
    for key, val in knobs.items():
        if key not in _VALID:
            raise ValueError(f"unknown training_fastpath knob {key!r}; "
                             f"known: {sorted(_VALID)}")
        if val not in _VALID[key]:
            raise ValueError(f"training_fastpath.{key} must be one of "
                             f"{_VALID[key]}, got {val!r}")
        _STATE[key] = val
    return dict(_STATE)


def fastpath(key: str) -> str:
    """The fleet default for one knob (``auto`` when never configured)."""
    return _STATE[key]


def reset_fastpath() -> None:
    _STATE.update(_DEFAULTS)
