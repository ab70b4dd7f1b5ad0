"""Atomic checkpoint store in the reference's on-disk format.

Port of ``repro.checkpoint.store``.  Layout per step directory (atomic via
rename)::

    <root>/step_<n>.tmp/            -> <root>/step_<n>/
        meta.json                   leaf keys + shapes + logical dtypes
                                    + an optional caller ``extra`` block
        proc0.npz                   every leaf's payload

The files are byte-compatible with the reference's: leaf keys are the
strings ``jax.tree_util.tree_flatten_with_path`` prints for the reference's
registered dataclasses (``.substrate/.func_probs``, ``.ledger/.archived``,
...; ``/`` becomes ``|`` inside the npz), built here from the dataclass
field order, and for a training checkpoint's ``(params, opt_state)``
(``0/embed``, ``0/layers/0/attn/wq``, ``1/.step``, ``1/.mu/embed``: a
tuple's items by index, a ``NamedTuple``'s fields as ``.name``); dtype
names are numpy's (``float32``, ``bool``, ``int32``,
``bfloat16``, ``uint32``); bf16 travels as its uint16 bytes
(``t.view(torch.int16)`` out, ``torch.from_numpy(...).view(torch.bfloat16)``
in), so no numpy bf16 type is needed.  A checkpoint written by either
package restores in the other.

Round-trip contract: every leaf restores bitwise with its logical dtype,
0-d leaves stay 0-d, and the empty tree is a valid checkpoint.  Restore is
STRICT: a ``like`` leaf whose shape or dtype disagrees with the stored
leaf, or a tree whose keys differ from the checkpoint's, is an error, never
a silent cast.

Over a mesh: a tree of DTensors is saved whole — every rank gathers each
leaf, rank 0 writes, and all wait for the rename — so the files are the
same whatever mesh wrote them; ``restore_checkpoint(..., shardings=,
mesh=)`` places each leaf onto the CURRENT mesh in its placements (each
rank keeps its own shard of the leaf it read), which may differ from the
mesh that saved it.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

# the dtypes a session state (and the reference's bitmask words) holds
_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "bool": torch.bool,
    "int32": torch.int32,
    "uint32": torch.uint32,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """A restore target's leaf: its shape and logical dtype, no data."""

    shape: tuple
    dtype: torch.dtype


def dtype_name(dtype) -> str:
    """numpy's name of a torch or numpy dtype (``torch.float32`` -> ``float32``)."""
    if isinstance(dtype, torch.dtype):
        try:
            return _DTYPE_NAMES[dtype]
        except KeyError:
            raise TypeError(f"no checkpoint dtype for {dtype}") from None
    return str(np.dtype(dtype))


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray, LeafSpec))


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(key, leaf)] in the reference's order and spelling: dataclass and
    ``NamedTuple`` fields in declaration order as ``.name``, dict keys
    sorted as ``key``, tuple items as their index, joined by ``/``; None is
    an empty subtree."""
    if tree is None:
        return []
    if _is_leaf(tree):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree):
        items = [(f".{f.name}", getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    elif _is_namedtuple(tree):
        items = [(f".{name}", getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), sub) for i, sub in enumerate(tree)]
    else:
        raise TypeError(f"checkpoint leaves must be tensors or arrays, got {type(tree)}")
    out = []
    for name, sub in items:
        out.extend(_flatten_with_paths(sub, f"{prefix}/{name}" if prefix else name))
    return out


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _unflatten(like, leaves: dict, prefix: str = ""):
    """Rebuild ``like``'s structure with ``leaves[key]`` at each leaf."""
    if like is None:
        return None
    if _is_leaf(like):
        return leaves[prefix]

    def key(name):
        return f"{prefix}/{name}" if prefix else name

    if dataclasses.is_dataclass(like):
        return dataclasses.replace(like, **{
            f.name: _unflatten(getattr(like, f.name), leaves, key(f".{f.name}"))
            for f in dataclasses.fields(like)
        })
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, name), leaves, key(f".{name}"))
                            for name in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(sub, leaves, key(str(i))) for i, sub in enumerate(like))
    return {k: _unflatten(v, leaves, key(str(k))) for k, v in like.items()}


def _to_storable(leaf) -> tuple:
    """-> (npz-serializable host array, logical dtype name); bf16 rides as
    its uint16 bytes."""
    if isinstance(leaf, torch.Tensor):
        if hasattr(leaf, "full_tensor"):  # a DTensor: its whole value (a collective)
            leaf = leaf.full_tensor()
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), dtype_name(t.dtype)
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _from_storable(stored: np.ndarray, logical_dtype: str) -> torch.Tensor:
    """Invert ``_to_storable`` -> a CPU tensor of the logical dtype, bitwise."""
    arr = np.array(stored, order="C")  # a writable copy; 0-d stays 0-d
    if logical_dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_checkpoint(root, step: int, tree: Any, extra: Optional[dict] = None) -> Path:
    """Write a checkpoint atomically; returns the final directory.

    ``extra`` is an optional JSON-able dict stored inside ``meta.json``
    under the same atomic rename: host-side metadata (event cursors, RNG
    states, epoch counters) that is never newer or older than the arrays it
    describes.  Read it back with ``load_meta``.
    """
    root = Path(root)
    final = root / f"step_{step:08d}"
    tmp = root / f"step_{step:08d}.tmp"
    flat = _flatten_with_paths(tree)
    meta = {"step": step, "leaves": {}, "time": time.time()}
    if extra is not None:
        meta["extra"] = extra
    payload = {}
    for key, leaf in flat:  # DTensor leaves gather here, on every rank alike
        stored, logical_dtype = _to_storable(leaf)
        meta["leaves"][key] = {"shape": list(stored.shape), "dtype": logical_dtype}
        payload[key.replace("/", "|")] = stored
    distributed = any(hasattr(leaf, "full_tensor") for _, leaf in flat)
    if not distributed or torch.distributed.get_rank() == 0:
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        # one process: every leaf in proc0.npz; zero arrays still make a valid archive
        np.savez(tmp / "proc0.npz", **payload)
        (tmp / "meta.json").write_text(json.dumps(meta))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)
    if distributed:
        torch.distributed.barrier()
    return final


def _complete_steps(root: Path) -> list:
    if not root.exists():
        return []
    return sorted(
        int(p.name.split("_")[1])
        for p in root.iterdir()
        if p.is_dir() and p.name.startswith("step_") and not p.name.endswith(".tmp")
        and (p / "meta.json").exists()
    )


def available_steps(root) -> list:
    """Ascending steps of every COMPLETE checkpoint under ``root`` (a
    ``step_*`` directory without ``meta.json`` is not a checkpoint)."""
    return _complete_steps(Path(root))


def latest_step(root) -> Optional[int]:
    steps = _complete_steps(Path(root))
    return steps[-1] if steps else None


def load_meta(root, step: Optional[int] = None) -> dict:
    """Read a checkpoint's ``meta.json`` (latest step when ``step`` is None):
    leaf shapes / dtypes and the caller's ``extra``, no array payload."""
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    meta["step"] = step  # authoritative even for hand-moved directories
    return meta


def restore_checkpoint(root, step: Optional[int], like: Any, device=None, shardings: Any = None,
                       mesh=None) -> tuple:
    """Restore into the structure of ``like`` (a tree of tensors or
    ``LeafSpec``s) on ``device`` -> (tree, step).

    Strict: every ``like`` leaf must exist in the checkpoint with the same
    shape AND logical dtype, and checkpoint leaves absent from ``like`` are
    reported.  ``device=None`` means ``cuda`` (raises without a GPU).
    ``shardings``: an optional tree of ``like``'s structure whose leaves are
    DTensor placements (None leaves a leaf plain), to place the leaves onto
    ``mesh``.
    """
    dev = resolve_device(device)
    root = Path(root)
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = root / f"step_{step:08d}"
    meta = json.loads((d / "meta.json").read_text())
    flat_like = _flatten_with_paths(like)
    like_keys = [k for k, _ in flat_like]
    missing = [k for k in like_keys if k not in meta["leaves"]]
    unused = [k for k in meta["leaves"] if k not in set(like_keys)]
    if missing or unused:
        raise ValueError(
            f"checkpoint step {step} does not match the restore target: "
            f"missing from checkpoint {missing or '[]'}, "
            f"present but unconsumed {unused or '[]'}"
        )
    leaves = {}
    with np.load(d / "proc0.npz") as payload:
        for key, leaf in flat_like:
            logical_dtype = meta["leaves"][key]["dtype"]
            stored = payload[key.replace("/", "|")]
            want_shape = tuple(leaf.shape)
            if tuple(stored.shape) != want_shape:
                raise ValueError(f"checkpoint leaf {key}: shape {stored.shape} != {want_shape}")
            want_dtype = dtype_name(leaf.dtype)
            if logical_dtype != want_dtype:
                raise ValueError(
                    f"checkpoint leaf {key}: dtype {logical_dtype} != {want_dtype} "
                    "(restore is bitwise; cast after restoring if you mean it)"
                )
            leaves[key] = _from_storable(stored, logical_dtype).to(dev)
    tree = _unflatten(like, leaves)
    if shardings is not None:
        if mesh is None:
            raise ValueError("restore_checkpoint(shardings=) needs the mesh to place them on")
        tree = _place(tree, shardings, mesh)
    return tree, step


def _place(tree, shardings, mesh):
    """Each tensor leaf of ``tree`` placed onto ``mesh`` in its placements
    from ``shardings`` (a tree of ``tree``'s structure)."""
    from repro_torch.models.sharding import place_whole

    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree if shardings is None else place_whole(tree, mesh, tuple(shardings))
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: _place(getattr(tree, f.name), getattr(shardings, f.name), mesh)
            for f in dataclasses.fields(tree)})
    if _is_namedtuple(tree):
        return type(tree)(*(_place(t, s, mesh) for t, s in zip(tree, shardings)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_place(t, s, mesh) for t, s in zip(tree, shardings))
    return {k: _place(v, shardings[k], mesh) for k, v in tree.items()}


def prune_old(root, keep: int = 3) -> list:
    """Delete all but the newest ``keep`` COMPLETE checkpoints -> deleted steps.

    ``keep`` must be >= 1; only complete steps count toward it; the newest
    complete step is never deleted while a ``.tmp`` sibling exists (an
    in-flight save may still crash before its rename); ``.tmp`` directories
    are never touched.
    """
    if keep < 1:
        raise ValueError(f"keep must be >= 1 (got {keep}); pruning every "
                         "checkpoint would leave nothing to restore")
    root = Path(root)
    steps = _complete_steps(root)
    if not steps:
        return []
    tmp_in_flight = any(
        p.is_dir() and p.name.startswith("step_") and p.name.endswith(".tmp")
        for p in root.iterdir()
    )
    protected = {steps[-1]} if tmp_in_flight else set()
    deleted = []
    for s in steps[:-keep]:
        if s in protected:
            continue
        shutil.rmtree(root / f"step_{s:08d}")
        deleted.append(s)
    return deleted
