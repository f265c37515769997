"""The NVMe swap tier of ZeRO-Offload: the port of
``deepspeed_tpu/runtime/zero/swapper.py``.

Reference ``deepspeed/runtime/swap_tensor/`` (``AsyncPartitionedParameterSwapper``,
the optimizer swapper) over the aio thread pool. A tree of tensors is
flattened (``torch.utils._pytree`` order) into ONE packed file per swap key,
beside an in-memory manifest of each leaf's path, shape, dtype, offset and
byte count; its writes and reads are striped over the native pool
(``ops/aio``). ``swap_out`` brings the leaves to host memory and starts the
writes; ``synchronize`` (or ``swap_in``) waits for them. ``swap_in``
rebuilds the tree with its structure and dtypes, on ``device`` when one is
given; a short read raises ``OSError`` naming the leaf.
"""

import os
from typing import Any, Dict, List, Optional

import torch
from torch.utils import _pytree as pytree


def _key_str(path) -> str:
    out = []
    for e in path:
        for attr in ("key", "name", "idx"):
            if hasattr(e, attr):
                out.append(str(getattr(e, attr)))
                break
        else:
            out.append(str(e))
    return "/".join(out)


class AsyncTensorSwapper:
    """Swap trees of tensors between memory and files under ``swap_dir``."""

    def __init__(self, swap_dir: str, num_threads: int = 8,
                 block_size: int = 1 << 20, use_o_direct: bool = False):
        from ...ops.aio import AsyncIOHandle

        self.swap_dir = swap_dir
        os.makedirs(swap_dir, exist_ok=True)
        self.handle = AsyncIOHandle(num_threads=num_threads, block_size=block_size,
                                    use_o_direct=use_o_direct)
        self._manifests: Dict[str, dict] = {}
        self._pending: Dict[str, List[int]] = {}
        self._specs: Dict[str, Any] = {}
        self._keepalive: Dict[str, list] = {}

    def _data_path(self, name: str) -> str:
        return os.path.join(self.swap_dir, f"{name}.swp")

    # ------------------------------------------------------------------
    def swap_out(self, name: str, tree: Any) -> None:
        """Write a tree of tensors to its file (asynchronously). The leaves
        are copied to host memory first; the copies stay referenced until
        ``synchronize``."""
        if name in self._pending:
            # never delete the file under the writes of an earlier swap_out
            self.synchronize(name)
        flat, spec = pytree.tree_flatten_with_path(tree)
        self._specs[name] = spec
        path = self._data_path(name)
        if os.path.exists(path):
            os.remove(path)
        # every device-to-host copy is issued before one wait
        leaves = [torch.as_tensor(leaf).detach() for _, leaf in flat]
        host = [t.to("cpu", non_blocking=True) for t in leaves]
        if any(t.is_cuda for t in leaves):
            torch.cuda.synchronize()
        host = [t.contiguous() for t in host]
        manifest, reqs = [], []
        offset = 0
        for (kp, _), t in zip(flat, host):
            nbytes = t.numel() * t.element_size()
            manifest.append({"key": _key_str(kp), "shape": list(t.shape),
                             "dtype": t.dtype, "offset": offset, "nbytes": nbytes})
            if nbytes:
                reqs.append(self.handle.async_pwrite(t, path, offset))
            offset += nbytes
        self._manifests[name] = {"entries": manifest, "total": offset}
        self._pending[name] = reqs
        self._keepalive[name] = host

    def synchronize(self, name: Optional[str] = None) -> None:
        names = [name] if name else list(self._pending)
        for n in names:
            for rid in self._pending.pop(n, []):
                self.handle.wait(rid)
            self._keepalive.pop(n, None)

    # ------------------------------------------------------------------
    def swap_in(self, name: str, device=None, delete: bool = False) -> Any:
        """Read a swapped tree back, its leaves on ``device`` (host memory
        when None); ``delete`` releases the key and its file after."""
        self.synchronize(name)
        man = self._manifests.get(name)
        spec = self._specs.get(name)
        if man is None or spec is None:
            raise RuntimeError(f"swap_in({name!r}): unknown swap name — swap_out must "
                               f"happen in this process (known: {self.swapped_names()})")
        path = self._data_path(name)
        bufs, reqs = [], []
        for e in man["entries"]:
            buf = torch.empty(e["shape"], dtype=e["dtype"])
            if e["nbytes"]:
                reqs.append((self.handle.async_pread(buf, path, e["offset"]), e))
            bufs.append(buf)
        for rid, e in reqs:
            got = self.handle.wait(rid)
            if got != e["nbytes"]:
                raise OSError(f"swap_in({name!r}): short read for {e['key']} — got {got} "
                              f"of {e['nbytes']} bytes (truncated or corrupt {path})")
        if device is not None:
            bufs = [b.to(device) for b in bufs]
        tree = pytree.tree_unflatten(bufs, spec)
        if delete:
            self.release(name)
        return tree

    def release(self, name: str) -> None:
        self.synchronize(name)
        p = self._data_path(name)
        if os.path.exists(p):
            os.remove(p)
        self._manifests.pop(name, None)
        self._specs.pop(name, None)

    def swapped_names(self):
        return sorted(self._manifests)
