"""Fault-tolerant checkpointing in the reference's on-disk layout
(``repro.train.checkpoint``'s port).

Layout (one directory per step), the reference's byte for byte:

    <dir>/step_000123/
        manifest.msgpack      -- {"step", "entries": [{"path", "file",
                                 "shape", "dtype", "crc"}], "extra"}
        arr_00000.npy ...     -- one file per reference leaf, in flatten
                                 order (a stacked leaf stacked)
        _COMMITTED            -- atomic commit marker (written last)

Paths are the reference's (``params/dense/wq``, ``opt/mu/embed``,
``step``; :mod:`.tree`), so a checkpoint written by either package restores
in the port.  bf16 leaves are written as the reference writes them (a
``'<V2'`` array of the bf16 bits, manifest dtype ``"bfloat16"``) and read
back by their bits, which the reference's own ``restore`` cannot do
(``ROADMAP.md`` §C).  The manifest goes through
:mod:`.msgpack_codec`, never the ``msgpack`` package.

Guarantees, as the reference's: step-atomic (only directories with
``_COMMITTED`` count), crc32 per leaf verified on restore, async saves
(``AsyncCheckpointer`` snapshots to host memory, then writes on a
thread), ``keep_last`` pruning.  ``restore`` fills the target's tensors in
place (a parameter module's too), so a restart does not hold two copies
of the state on the card.  Both write and read the leaves on a few
threads at once (their file I/O and crc32 release the GIL).
"""
from __future__ import annotations

import concurrent.futures as cf
import os
import pathlib
import shutil
import zlib
from typing import Any, Optional

import numpy as np
import torch

from . import msgpack_codec
from . import tree as T


class HostBF16:
    """A bf16 leaf on the host: its bits, an int16 array."""

    def __init__(self, bits: np.ndarray):
        self.bits = bits

    @property
    def shape(self):
        return self.bits.shape


def _parallel(fn, n: int) -> list:
    """``[fn(i) for i in range(n)]`` on a few threads: the leaves' file
    reads and writes and their crc32 release the GIL.  Half the cores at
    most, so that an async save leaves the train loop cores to run on."""
    if n <= 1:
        return [fn(i) for i in range(n)]
    workers = min(8, n, max(1, (os.cpu_count() or 2) // 2))
    with cf.ThreadPoolExecutor(workers) as pool:
        return list(pool.map(fn, range(n)))


def _flatten_with_paths(tree):
    pairs = T.items(tree)
    return ["/".join(p) for p, _ in pairs], [leaf for _, leaf in pairs]


def _host(leaf):
    """A leaf as a host array: numpy, or :class:`HostBF16` for bf16 (a
    stacked leaf stacked)."""
    if isinstance(leaf, HostBF16):
        return leaf
    if isinstance(leaf, np.ndarray) and leaf.dtype.name == "bfloat16":
        return HostBF16(leaf.view(np.int16))     # an ml_dtypes array
    if isinstance(leaf, np.ndarray):
        return leaf
    if isinstance(leaf, (list, tuple)) or torch.is_tensor(leaf):
        ts = T.layers(leaf)
        bf16 = ts[0].dtype == torch.bfloat16
        dt = np.int16 if bf16 else torch.empty(
            (), dtype=ts[0].dtype).numpy().dtype
        out = np.empty(T.shape(leaf), dtype=dt)
        for l, t in enumerate(ts):
            dst = torch.from_numpy(out[l] if isinstance(leaf, (list, tuple))
                                   else out)
            dst.copy_((t.view(torch.int16) if bf16 else t).detach())
        return HostBF16(out) if bf16 else out
    return np.asarray(leaf)


def _crc(arr: np.ndarray) -> int:
    flat = np.ascontiguousarray(arr).reshape(-1).view(np.uint8)
    return zlib.crc32(flat) & 0xFFFFFFFF


def _write(path: pathlib.Path, host) -> tuple:
    """Write one leaf; returns (bytes array, dtype name)."""
    if isinstance(host, HostBF16):
        arr = np.ascontiguousarray(host.bits)
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": "<V2", "fortran_order": False,
                    "shape": arr.shape})
            f.write(arr.reshape(-1).view(np.uint8))
        return arr, "bfloat16"
    np.save(path, host)
    return host, str(host.dtype)


def save(tree: Any, directory: str, step: int, keep_last: int = 3,
         extra: Optional[dict] = None) -> str:
    """Synchronous atomic checkpoint; returns the committed path."""
    base = pathlib.Path(directory)
    ckpt = base / f"step_{step:08d}"
    tmp = base / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)

    paths, leaves = _flatten_with_paths(tree)

    def one(i):
        fname = f"arr_{i:05d}.npy"
        arr, dtype = _write(tmp / fname, _host(leaves[i]))
        return {"path": paths[i], "file": fname, "shape": list(arr.shape),
                "dtype": dtype, "crc": _crc(arr)}
    entries = _parallel(one, len(leaves))
    manifest = {"step": step, "entries": entries, "extra": extra or {}}
    (tmp / "manifest.msgpack").write_bytes(msgpack_codec.packb(manifest))
    (tmp / "_COMMITTED").write_bytes(b"ok")
    if ckpt.exists():
        shutil.rmtree(ckpt)
    os.replace(tmp, ckpt)
    _prune(base, keep_last)
    return str(ckpt)


class AsyncCheckpointer:
    """Snapshot-to-host synchronously, write in the background.

    ``wait()`` joins outstanding writes (call before exit / next save of the
    same step).  A failed write is re-raised on the next call."""

    def __init__(self, directory: str, keep_last: int = 3):
        self.directory = directory
        self.keep_last = keep_last
        self._pool = cf.ThreadPoolExecutor(max_workers=1)
        self._future: Optional[cf.Future] = None

    def save(self, tree: Any, step: int, extra: Optional[dict] = None):
        self.wait()
        host_tree = T.unflatten([(p, _host(leaf))
                                 for p, leaf in T.items(tree)])
        self._future = self._pool.submit(
            save, host_tree, self.directory, step, self.keep_last, extra)

    def wait(self) -> Optional[str]:
        if self._future is not None:
            result = self._future.result()
            self._future = None
            return result
        return None


def latest_step(directory: str) -> Optional[int]:
    base = pathlib.Path(directory)
    if not base.exists():
        return None
    steps = []
    for d in base.iterdir():
        if d.name.startswith("step_") and (d / "_COMMITTED").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def _source(arr: np.ndarray, dtype: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")     # keeps 0-d arrays 0-d
    if dtype == "bfloat16" or arr.dtype.kind == "V":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def restore(directory: str, target: Any, step: Optional[int] = None,
            strict_integrity: bool = True):
    """Restore into the structure of ``target`` -> (tree, extra).  Tensor
    leaves (a stacked leaf's layers, a parameter module's tensors) are
    filled in place, cast to their dtype, and returned as they are; numpy
    leaves come back as new arrays of their dtype (bf16 leaves as int16
    bits in a :class:`HostBF16`)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    ckpt = pathlib.Path(directory) / f"step_{step:08d}"
    manifest = msgpack_codec.unpackb(
        (ckpt / "manifest.msgpack").read_bytes())

    paths, leaves = _flatten_with_paths(target)
    by_path = {e["path"]: e for e in manifest["entries"]}

    def one(i):
        p, leaf = paths[i], leaves[i]
        e = by_path.get(p)
        if e is None:
            raise KeyError(f"checkpoint missing leaf {p}")
        arr = np.load(ckpt / e["file"])
        if strict_integrity and _crc(arr) != e["crc"]:
            raise IOError(f"checksum mismatch for {p} in {ckpt}")
        want_shape = T.shape(leaf)
        if tuple(arr.shape) != want_shape:
            raise ValueError(f"shape mismatch for {p}: "
                             f"{arr.shape} vs {want_shape}")
        src = _source(arr, e["dtype"])
        if isinstance(leaf, (list, tuple)) or torch.is_tensor(leaf):
            with torch.no_grad():      # grad mode is per thread
                for l, t in enumerate(T.layers(leaf)):
                    t.copy_(src[l] if isinstance(leaf, (list, tuple))
                            else src)
            return leaf
        if isinstance(leaf, HostBF16) or np.asarray(
                leaf).dtype.name == "bfloat16":
            return HostBF16(src.to(torch.bfloat16).view(torch.int16).numpy())
        return src.to(torch.from_numpy(
            np.empty((), np.asarray(leaf).dtype)).dtype).numpy()

    out = _parallel(one, len(leaves))
    return (T.unflatten([(tuple(p.split("/")), x)
                         for p, x in zip(paths, out)]),
            manifest.get("extra", {}))


def _prune(base: pathlib.Path, keep_last: int):
    steps = sorted(d for d in base.iterdir()
                   if d.name.startswith("step_")
                   and (d / "_COMMITTED").exists())
    for d in steps[:-keep_last]:
        shutil.rmtree(d, ignore_errors=True)
