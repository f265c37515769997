"""The port's asynchronous file I/O and NVMe swapper (``ops/aio``,
``runtime/zero/swapper.py``) on the CPU: the cases of the JAX package's
``tests/unit/test_aio.py`` (round trip, many concurrent striped requests,
offsets and partial reads, errors, zero bytes, the swapper's round trip),
files written by one package read by the other's handle, a short read
naming its leaf, and the buffers the handle refuses."""

import os

import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.aio import AsyncIOHandle as JaxHandle
from deepspeed_tpu_torch import zero
from deepspeed_tpu_torch.ops.aio import AsyncIOBuilder, AsyncIOHandle
from deepspeed_tpu_torch.runtime.zero.swapper import AsyncTensorSwapper


def test_builder_builds_once_and_loads():
    lib = AsyncIOBuilder().load()
    assert AsyncIOBuilder().load() is lib
    assert lib.dstpu_aio_version() == 1
    assert AsyncIOBuilder().is_compatible()


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_sync_round_trip(tmp_path, kind):
    h = AsyncIOHandle(num_threads=4, block_size=1 << 16)
    data = np.random.default_rng(0).integers(0, 255, size=1 << 20, dtype=np.uint8)
    buf = torch.from_numpy(data) if kind == "tensor" else data
    path = str(tmp_path / "x.bin")
    assert h.pwrite(buf, path) == data.nbytes
    out = torch.empty_like(buf) if kind == "tensor" else np.empty_like(data)
    assert h.pread(out, path) == data.nbytes
    np.testing.assert_array_equal(np.asarray(out), data)


def test_many_concurrent_requests(tmp_path):
    h = AsyncIOHandle(num_threads=8, block_size=4096)
    rng = np.random.default_rng(1)
    bufs = [torch.from_numpy(rng.integers(0, 255, size=int(rng.integers(1, 200_000)),
                                          dtype=np.uint8)) for _ in range(32)]
    reqs = [h.async_pwrite(b, str(tmp_path / f"f{i}.bin")) for i, b in enumerate(bufs)]
    for rid, b in zip(reqs, bufs):
        assert h.wait(rid) == b.numel()
    outs = [torch.empty_like(b) for b in bufs]
    for i, o in enumerate(outs):
        h.async_pread(o, str(tmp_path / f"f{i}.bin"))
    h.wait_all()
    assert h.pending() == 0
    assert all(torch.equal(o, b) for o, b in zip(outs, bufs))


def test_offsets_partial_reads_and_the_jax_handle(tmp_path):
    """A file the port writes is read by the JAX package's handle and the
    other way round; reads at an offset and past the end."""
    h, j = AsyncIOHandle(num_threads=2), JaxHandle(num_threads=2)
    data = torch.arange(1000, dtype=torch.int32)
    path = str(tmp_path / "off.bin")
    h.pwrite(data, path)
    out = torch.empty(10, dtype=torch.int32)
    h.pread(out, path, offset=100 * 4)
    assert torch.equal(out, torch.arange(100, 110, dtype=torch.int32))
    theirs = np.empty(1000, np.int32)
    assert j.pread(theirs, path) == 4000
    np.testing.assert_array_equal(theirs, data.numpy())
    j.pwrite(np.arange(7, dtype=np.float64), str(tmp_path / "j.bin"))
    back = torch.empty(7, dtype=torch.float64)
    h.pread(back, str(tmp_path / "j.bin"))
    assert torch.equal(back, torch.arange(7, dtype=torch.float64))
    tail = torch.empty(20, dtype=torch.int32)
    assert h.pread(tail, path, offset=990 * 4) == 40        # a short read at the end


def test_errors_and_refused_buffers(tmp_path):
    h = AsyncIOHandle(num_threads=2)
    with pytest.raises(OSError):
        h.pread(torch.empty(10, dtype=torch.uint8), str(tmp_path / "missing.bin"))
    with pytest.raises(ValueError, match="contiguous"):
        h.pwrite(torch.zeros(4, 4).t(), str(tmp_path / "s.bin"))
    with pytest.raises(ValueError, match="contiguous"):
        h.pwrite(np.zeros((4, 4)).T, str(tmp_path / "s.bin"))
    ro = np.zeros(4)
    ro.flags.writeable = False
    h.pwrite(ro, str(tmp_path / "ro.bin"))                   # writing from it is fine
    with pytest.raises(ValueError, match="not writable"):
        h.pread(ro, str(tmp_path / "ro.bin"))
    with pytest.raises(TypeError):
        h.pwrite([1, 2, 3], str(tmp_path / "l.bin"))


def test_zero_byte_request(tmp_path):
    h = AsyncIOHandle(num_threads=2)
    assert h.pwrite(torch.empty(0, dtype=torch.uint8), str(tmp_path / "z.bin")) == 0
    h.close()
    h.close()


def test_swapper_round_trip_and_release(tmp_path):
    assert zero.AsyncTensorSwapper is AsyncTensorSwapper
    sw = zero.AsyncTensorSwapper(str(tmp_path), num_threads=4)
    tree = {"a": torch.arange(1024, dtype=torch.float32).reshape(32, 32),
            "b": {"c": torch.ones(7, dtype=torch.bfloat16),
                  "d": torch.tensor(3, dtype=torch.int32), "e": torch.empty(0)},
            "f": [torch.full((3, 5), -2.5, dtype=torch.float64)[:, 1]]}
    sw.swap_out("opt", tree)
    assert sw.swapped_names() == ["opt"]
    back = sw.swap_in("opt")
    flat, spec = torch.utils._pytree.tree_flatten(back)
    want, want_spec = torch.utils._pytree.tree_flatten(tree)
    assert spec == want_spec
    for x, y in zip(flat, want):
        assert x.dtype == y.dtype and torch.equal(x, y)
    assert os.path.getsize(str(tmp_path / "opt.swp")) == sum(
        t.numel() * t.element_size() for t in want)
    sw.release("opt")
    assert sw.swapped_names() == [] and not (tmp_path / "opt.swp").exists()
    with pytest.raises(RuntimeError, match="unknown swap name"):
        sw.swap_in("opt")


def test_swapper_short_read_names_the_leaf(tmp_path):
    sw = AsyncTensorSwapper(str(tmp_path), num_threads=2)
    sw.swap_out("st", {"m": torch.zeros(100), "v": torch.ones(100)})
    sw.synchronize("st")
    with open(tmp_path / "st.swp", "r+b") as f:
        f.truncate(500)                 # v's bytes are 400-800
    with pytest.raises(OSError, match="short read for v"):
        sw.swap_in("st")
    assert sw.swapped_names() == ["st"]     # known until released
    sw.release("st")
    assert sw.swapped_names() == []


def test_plain_versions_read_what_the_handle_writes(tmp_path):
    from deepspeed_tpu_torch.ops import aio

    data = torch.arange(5000, dtype=torch.float32)
    path = str(tmp_path / "p.bin")
    aio.reset_launch_counts()
    AsyncIOHandle(num_threads=3, block_size=4096).pwrite(data, path)
    assert aio.launch_counts["aio"] == 1
    back = torch.empty_like(data)
    assert aio.plain_pread(back, path) == 20000 and torch.equal(back, data)
    assert aio.plain_pwrite(np.arange(10, dtype=np.int64), path, offset=8) == 80
    head = torch.empty(3, dtype=torch.int64)
    AsyncIOHandle(num_threads=1).pread(head, path)
    assert head[1:].tolist() == [0, 1]
