"""Declarative sharding: the one source of the port's tensor-parallel layout.

Port of ``deepspeed_tpu/sharding/``:

``rules``  — regex-path -> spec engine (precedence, overlap and axis
             validation, versioned JSON serialization).
``packs``  — built-in rule packs for the HF model-family tree shapes.
``derive`` — the AutoTP bridge: name inference -> explicit rules.
``sites``  — named activation layouts of the parallel paths.
``autotp`` — ``autotp_initialize``: checkpoint -> tensor-parallel engine.
"""

from . import sites  # noqa: F401
from .autotp import (autotp_initialize, register_param_collectives,  # noqa: F401
                     resolve_rules, shard_checkpoint_tree)
from .derive import derive_rules, derived_matches_parser  # noqa: F401
from .packs import (PACKS, generic_pack, get_pack,  # noqa: F401
                    gpt2_pack, gpt_neox_pack, llama_pack, mistral_pack,
                    mixtral_pack, pack_for_config)
from .rules import (RULES_FORMAT, AmbiguousRuleError,  # noqa: F401
                    ForeignModelShardingError, PartitionSpec, Rule, RuleSet,
                    RulesFormatError, ShardingRuleError, UnknownAxisError,
                    UnmatchedParamError, spec_tree_axis_sizes)
