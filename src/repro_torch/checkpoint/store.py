"""Atomic, async checkpoints with monoid-merge resume: the port of the JAX
package's ``checkpoint/store.py``, with its on-disk layout::

    <dir>/step_00000042/
        manifest.json        # leaf keys, dtypes, shapes, monoid tags
        arrays/<n>.bin       # raw little-endian bytes per leaf
    <dir>/LATEST             # atomic pointer (text file, os.replace'd)

Leaves are listed in the JAX package's order (dict keys sorted, then list
and tuple positions) under its key strings (``['m']['w']``, ``[0]``), with
numpy's dtype names (bfloat16 as its raw 16-bit pattern), so a checkpoint
of plain dicts, lists and tuples of arrays written by either package
restores in the other, bit for bit.

* **Atomic** -- a step directory is staged under ``.tmp-...`` and
  ``os.replace``d into place; LATEST is updated last.  A crash mid-save
  never corrupts the previous checkpoint.
* **Async** -- ``save_async`` copies the tensors to the host now (the one
  device sync) and writes them in a background thread; ``wait()`` joins.
* **Monoid-merge resume** -- accumulators (metrics, data-pipeline sketches)
  are saved as monoid values with their monoid name in the manifest.  On
  restore, training resumes at step k and the accumulator of steps [0, k)
  combines with the new partial aggregate; associativity makes restart
  exact.
* **Mesh-agnostic** -- under a mesh each rank holds its blocks
  (``dist/sharding.py``).  ``save(..., shardings=)`` gathers every cut leaf
  on every rank (a collective), rank 0 alone writes the whole arrays, and
  the ranks meet at a barrier once the write is done; ``restore(...,
  shardings=)`` reads the whole arrays and keeps each rank's block of the
  mesh it restores onto, which need not be the saver's (the elastic
  re-mesh path of ``runtime/fault_tolerance.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

Pytree = Any

_TORCH_OF = {
    "bfloat16": torch.bfloat16, "float32": torch.float32,
    "float16": torch.float16, "float64": torch.float64, "int8": torch.int8,
    "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32,
    "bool": torch.bool,
}
_NAME_OF = {v: k for k, v in _TORCH_OF.items()}


def _flatten(tree: Pytree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key string, leaf) pairs in the JAX package's order: dict keys
    sorted, sequences by position; anything else is a leaf."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, x in enumerate(tree):
            out += _flatten(x, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like: Pytree, leaves: List[Any]) -> Pytree:
    """``like``'s structure holding ``leaves`` in :func:`_flatten`'s order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            vals = {k: build(t[k]) for k in sorted(t)}
            return {k: vals[k] for k in t}          # like's key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(like)


def _to_host(tree: Pytree) -> List[Tuple[str, np.ndarray, str]]:
    """(key, host bytes as a numpy array, dtype name) per leaf."""
    out = []
    for key, leaf in _flatten(tree):
        t = torch.as_tensor(leaf).detach()
        name = _NAME_OF.get(t.dtype)
        if name is None:
            raise TypeError(f"checkpoint leaf {key} has unsupported dtype "
                            f"{t.dtype}")
        t = t.to("cpu").contiguous()
        arr = t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 \
            else t.numpy()
        out.append((key, arr, name))
    return out


def _step_dir(base: str, step: int) -> str:
    return os.path.join(base, f"step_{step:08d}")


class CheckpointStore:
    def __init__(self, base_dir: str, *, keep: int = 3):
        self.base = base_dir
        self.keep = keep
        os.makedirs(base_dir, exist_ok=True)
        self._pool = ThreadPoolExecutor(max_workers=1)
        self._pending: Optional[Future] = None
        self._barrier = False

    # -- save -----------------------------------------------------------------
    def _host(self, tree, aggregates, shardings, mesh):
        """(whether this rank writes, the leaves on the host, the
        aggregates'); under a mesh the cut leaves are gathered first."""
        writes = True
        if shardings is not None:
            import torch.distributed as tdist
            from ..dist.sharding import _walk, gather_leaf
            writes = not tdist.is_initialized() or tdist.get_rank() == 0

            def whole(t, spec):     # on the host leaf by leaf: one whole
                t = gather_leaf(torch.as_tensor(t).detach(), spec, mesh)
                return t.to("cpu") if writes else None  # leaf on the card
            tree = _walk(whole, tree, shardings)
        if not writes:
            return False, None, None
        return True, _to_host(tree), {
            k: (mn, _to_host(v)) for k, (mn, v) in (aggregates or {}).items()}

    def save(self, step: int, tree: Pytree, *,
             aggregates: Optional[Dict[str, Tuple[str, Pytree]]] = None,
             shardings: Optional[Pytree] = None, mesh=None) -> str:
        """Blocking save.  ``aggregates`` maps name -> (monoid_name, value).
        With ``shardings`` (a spec tree shaped like ``tree``) each leaf is
        this rank's block on ``mesh`` (default: the bound one): every rank
        calls this, rank 0 writes the whole arrays, then a barrier."""
        self.wait()
        writes, host, agg_host = self._host(tree, aggregates, shardings,
                                            mesh)
        path = self._write(step, host, agg_host) if writes else \
            _step_dir(self.base, step)
        if shardings is not None:
            import torch.distributed as tdist
            tdist.barrier()
        return path

    def save_async(self, step: int, tree: Pytree, *,
                   aggregates: Optional[Dict[str, Tuple[str, Pytree]]] = None,
                   shardings: Optional[Pytree] = None, mesh=None
                   ) -> Optional[Future]:
        """Device -> host copy now (under a mesh the gather too); the disk
        write in the background; ``wait()`` joins it (and, under a mesh,
        meets the other ranks at a barrier)."""
        self.wait()
        writes, host, agg_host = self._host(tree, aggregates, shardings,
                                            mesh)
        if writes:
            self._pending = self._pool.submit(self._write, step, host,
                                              agg_host)
        self._barrier = shardings is not None
        return self._pending

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.result()
            self._pending = None
        if self._barrier:
            import torch.distributed as tdist
            self._barrier = False
            tdist.barrier()

    def _write(self, step: int, host, agg_host) -> str:
        final = _step_dir(self.base, step)
        tmp = os.path.join(self.base, f".tmp-{step}-{os.getpid()}-"
                                      f"{time.monotonic_ns()}")
        arrays = os.path.join(tmp, "arrays")
        os.makedirs(arrays, exist_ok=True)
        manifest = {"step": step, "leaves": [], "aggregates": {}}
        idx = 0

        def dump(entries, into: List):
            nonlocal idx
            for key, arr, name in entries:
                fname = f"{idx}.bin"
                with open(os.path.join(arrays, fname), "wb") as f:
                    f.write(np.ascontiguousarray(arr).astype(
                        arr.dtype.newbyteorder("<"), copy=False).tobytes())
                into.append({"key": key, "file": fname, "dtype": name,
                             "shape": list(arr.shape)})
                idx += 1

        dump(host, manifest["leaves"])
        for name, (mname, entries) in agg_host.items():
            manifest["aggregates"][name] = {"monoid": mname, "leaves": []}
            dump(entries, manifest["aggregates"][name]["leaves"])
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._update_latest(step)
        self._gc()
        return final

    def _update_latest(self, step: int) -> None:
        tmp = os.path.join(self.base, ".LATEST.tmp")
        with open(tmp, "w") as f:
            f.write(str(step))
        os.replace(tmp, os.path.join(self.base, "LATEST"))

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(_step_dir(self.base, s), ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self) -> List[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.base)
                      if d.startswith("step_"))

    def latest_step(self) -> Optional[int]:
        p = os.path.join(self.base, "LATEST")
        if not os.path.exists(p):
            steps = self.all_steps()
            return steps[-1] if steps else None
        with open(p) as f:
            return int(f.read().strip())

    @staticmethod
    def _read_leaf(d: str, e: dict) -> torch.Tensor:
        """The leaf of manifest entry ``e`` on the host."""
        with open(os.path.join(d, "arrays", e["file"]), "rb") as f:
            buf = bytearray(f.read())
        dt = _TORCH_OF[e["dtype"]]
        raw = torch.uint16 if dt == torch.bfloat16 else dt
        t = torch.frombuffer(buf, dtype=raw) if buf else \
            torch.empty((0,), dtype=raw)
        return t.view(dt).reshape(e["shape"])

    def _read_leaves(self, d: str, entries: List[dict]) -> List[torch.Tensor]:
        return [self._read_leaf(d, e) for e in entries]

    @staticmethod
    def _place(like: Pytree, leaves: List[torch.Tensor]) -> Pytree:
        """``leaves`` in ``like``'s structure, each on its ``like`` leaf's
        device when that leaf is a tensor (else on the CPU)."""
        likes = [x for _, x in _flatten(like)]
        if len(likes) != len(leaves):
            raise ValueError(f"checkpoint has {len(leaves)} leaves, expected "
                             f"{len(likes)}")
        return _unflatten(like, [
            t.to(x.device) if isinstance(x, torch.Tensor) else t
            for t, x in zip(leaves, likes)])

    def _manifest(self, step: int) -> Tuple[str, dict]:
        d = _step_dir(self.base, step)
        with open(os.path.join(d, "manifest.json")) as f:
            return d, json.load(f)

    def restore(self, like: Pytree, *, step: Optional[int] = None,
                shardings: Optional[Pytree] = None, mesh=None,
                coords: Optional[Dict[str, int]] = None
                ) -> Tuple[int, Pytree]:
        """Restore into the structure of ``like`` (values ignored; each
        leaf lands on its ``like`` leaf's device, in the saved dtype).

        ``shardings`` (a spec tree shaped like ``like``) restores onto a
        mesh: each leaf is this rank's block on ``mesh`` (default: the
        bound one; a ``{axis: size}`` mapping with ``coords`` stands for a
        rank of a simulated one), a copy of its own.  The arrays on disk
        are whole, so the mesh need not be the saver's."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.base}")
        d, manifest = self._manifest(step)
        if shardings is None:
            return step, self._place(like, self._read_leaves(
                d, manifest["leaves"]))
        from .. import dist
        from ..dist.sharding import _walk, block_of
        mesh = dist.current_mesh() if mesh is None else mesh
        entries = manifest["leaves"]
        n = len(_flatten(like))
        if n != len(entries):
            raise ValueError(f"checkpoint has {len(entries)} leaves, "
                             f"expected {n}")
        # each leaf's block as it is read: the whole leaf is freed at once
        read = _unflatten(like, [lambda e=e: self._read_leaf(d, e)
                                 for e in entries])
        blocks = _walk(lambda r, sp: block_of(r(), sp, mesh, coords), read,
                       shardings)
        return step, self._place(like, [t for _, t in _flatten(blocks)])

    def restore_aggregate(self, name: str, like: Pytree, *,
                          step: Optional[int] = None) -> Optional[Pytree]:
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        d, manifest = self._manifest(step)
        agg = manifest["aggregates"].get(name)
        if agg is None:
            return None
        return self._place(like, self._read_leaves(d, agg["leaves"]))
