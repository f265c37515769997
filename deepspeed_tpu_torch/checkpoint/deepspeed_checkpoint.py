"""Checkpoint inspector — the reference ``DeepSpeedCheckpoint`` vocabulary.

Port of ``deepspeed_tpu/checkpoint/deepspeed_checkpoint.py``: a reader over
the port's ``<dir>/<tag>/{state, metadata.json}`` layout
(``checkpoint/engine.py``) answering the questions the universal-checkpoint
tooling asks (source parallel degrees, layer keys, state access).
"""

import json
import os
import re
from typing import Any, Dict, List, Optional

__all__ = ["DeepSpeedCheckpoint"]


class DeepSpeedCheckpoint:
    def __init__(self, dir: str, tag: Optional[str] = None):
        from .engine import read_latest_tag

        self.dir = os.path.abspath(dir)
        if tag is None:
            tag = read_latest_tag(self.dir)
            if tag is None:
                raise FileNotFoundError(
                    f"no 'latest' tag file in {self.dir}; pass tag= explicitly")
        self.tag = str(tag)
        self.path = os.path.join(self.dir, self.tag)
        meta_path = os.path.join(self.path, "metadata.json")
        if not os.path.exists(meta_path):
            raise FileNotFoundError(f"not a deepspeed_tpu checkpoint: {meta_path}")
        with open(meta_path) as f:
            self.metadata: Dict[str, Any] = json.load(f)
        topo = self.metadata.get("topology", {})
        self.tp_degree = int(topo.get("tp", 1))
        self.pp_degree = int(topo.get("pp", 1))
        self.dp_degree = int(topo.get("dp", 1))
        self.ep_degree = int(topo.get("ep", 1))
        self.sp_degree = int(topo.get("sp", 1))
        # dp already folds ep in (dp = dp_outer * ep)
        self.original_world_size = (self.tp_degree * self.pp_degree
                                    * self.dp_degree * self.sp_degree)
        self.world_size = self.original_world_size
        self.global_steps = int(self.metadata.get("global_steps", 0))
        self.client_state = self.metadata.get("client_state", {})
        self._tree = None  # load_state_tree cache (reads are expensive)

    # -- discovery ------------------------------------------------------
    @staticmethod
    def get_tags(dir: str) -> List[str]:
        """All committed checkpoint tags under ``dir``, in natural order
        (global_step10 after global_step9)."""
        def natural(name):
            return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", name)]

        return sorted((name for name in os.listdir(os.path.abspath(dir))
                       if os.path.exists(os.path.join(dir, name, "metadata.json"))),
                      key=natural)

    def validate_files(self) -> None:
        """Reference ``validate_files``: the state must exist."""
        state = os.path.join(self.path, "state")
        if not os.path.isdir(state):
            raise FileNotFoundError(f"checkpoint state missing: {state}")

    # -- content --------------------------------------------------------
    def load_state_tree(self) -> Any:
        """The full saved tree (params, opt_state, step, loss_scale) as host
        tensors. Cached: repeat inspections must not re-read the store."""
        if self._tree is None:
            from .engine import TorchCheckpointEngine

            self._tree = TorchCheckpointEngine().load(os.path.join(self.path, "state"))
        return self._tree

    def get_layer_keys(self) -> List[str]:
        """Top-level parameter group names (the param tree's first level)."""
        tree = self.load_state_tree()
        params = tree.get("params", tree) if isinstance(tree, dict) else tree
        return sorted(params) if isinstance(params, dict) else []

    def show_3d_mapping(self) -> Dict[str, int]:
        """Reference debug helper: the source parallel degrees."""
        return {"tp": self.tp_degree, "pp": self.pp_degree,
                "dp": self.dp_degree, "ep": self.ep_degree,
                "sp": self.sp_degree}
