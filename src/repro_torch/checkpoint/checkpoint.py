"""Sharded, atomic, elastic checkpoints (``repro/checkpoint/checkpoint.py``).

Layout:  <dir>/step_<N>/
             manifest.json       tree structure + shapes/dtypes + extras
             leaf_<i>.npy        one file per tree leaf

The layout is the JAX package's, file for file, so each package restores
what the other wrote: the leaves of a nested dict (lists and tuples in
order, ``None`` an empty subtree) are numbered in the order of JAX's
sorted-key flatten, and a bf16 leaf is stored as two-byte voids (``<V2``,
as numpy writes ``ml_dtypes.bfloat16``) under the dtype string
``bfloat16`` in the manifest. Leaves are torch tensors (copied to the host
to save them; those on a CUDA device too), numpy arrays or scalars; a
restore gives torch tensors.

Guarantees:
  * **atomicity** — written to ``.tmp-step_<N>`` and renamed only when every
    leaf + manifest is on disk (manifest last, fsynced, directory entry
    fsynced after the publish rename), so a killed writer never leaves a
    torn checkpoint that ``restore``/``latest_step`` will pick up.
  * **validation on read** — a ``step_<N>`` directory only counts as a
    checkpoint when its manifest parses and every leaf file it names is
    present with a real ``.npy`` header; anything else is skipped with a
    warning and recovery falls back to the next-newest complete step
    instead of raising mid-recovery.
  * **async** — :class:`AsyncCheckpointer` snapshots to host memory
    synchronously and writes in a background thread; a background failure
    is re-raised as :class:`CheckpointError` on the next ``save()``/
    ``wait()`` (never swallowed), and ``wait(timeout=...)`` bounds shutdown.
  * **elastic restore** — leaves are stored as full arrays and placed on
    whatever ``device`` the restoring run names (else where the template's
    tensors are).
  * retention of the last ``keep`` checkpoints.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import threading
import warnings
from pathlib import Path

import numpy as np
import torch

_STEP_RE = re.compile(r"^step_(\d+)$")
_NPY_MAGIC = b"\x93NUMPY"
#: the .npy descr numpy writes for ml_dtypes' bfloat16 (a two-byte void)
_BF16_DESCR = "<V2"
#: integer views of the torch dtypes numpy cannot hold, by item size
_INT_OF_SIZE = {1: (np.int8, torch.int8), 2: (np.int16, torch.int16)}


class CheckpointError(RuntimeError):
    """A checkpoint could not be written or read back."""


# -- pytrees: nested dicts (sorted keys), lists and tuples, None -------------


def _flatten(tree) -> list:
    """The leaves of ``tree`` in the order of JAX's ``tree_flatten``."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _flatten(v)]
    return [tree]


def _unflatten(template, leaves):
    """``template``'s structure with its leaves taken, in order, from ``leaves``."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}  # the template's own key order
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return next(it)

    return build(template)


def _treedef(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for these pytrees."""
    def s(t):
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {s(t[k])}" for k in sorted(t)) + "}"
        if isinstance(t, list):
            return "[" + ", ".join(s(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(s(v) for v in t)
            return f"({inner},)" if len(t) == 1 else f"({inner})"
        return "*"

    return f"PyTreeDef({s(tree)})"


# -- leaves ------------------------------------------------------------------


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """(host array, dtype string) of a leaf; a bf16 tensor as its 16-bit pattern."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        name = str(t.dtype).removeprefix("torch.")
        if t.dtype.is_floating_point and t.dtype not in (torch.float16, torch.float32,
                                                         torch.float64):
            np_int, t_int = _INT_OF_SIZE[t.element_size()]
            return t.contiguous().view(t_int).numpy().view(np_int), name
        return t.numpy(), name
    arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_leaf(path: Path, arr: np.ndarray, dtype_str: str) -> None:
    if dtype_str == "bfloat16":
        # np.save of an ml_dtypes.bfloat16 array writes this header
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(
                f, {"descr": _BF16_DESCR, "fortran_order": False, "shape": arr.shape})
            f.write(np.ascontiguousarray(arr).view(np.uint16).astype("<u2").tobytes())
    else:
        np.save(path, arr)


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"no torch dtype for {name!r}")
    return dt


def _decode(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A CPU tensor of a loaded leaf; voids (bf16 etc.) viewed back by name."""
    if arr.dtype.kind == "V":
        dt = _torch_dtype(dtype_str)
        np_int, t_int = _INT_OF_SIZE[arr.dtype.itemsize]
        return torch.from_numpy(np.array(arr.view(np_int))).view(t_int).view(dt)
    return torch.from_numpy(np.array(arr))


def _dtype_of(leaf) -> torch.dtype:
    if isinstance(leaf, torch.Tensor):
        return leaf.dtype
    return _torch_dtype(str(np.asarray(leaf).dtype))


def _fsync(path: Path) -> None:
    """Flush one file (or directory entry) to stable storage; best-effort."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def save(ckpt_dir, step: int, state, extras: dict | None = None, keep: int = 3):
    """Synchronous crash-atomic save of a pytree ``state``.

    Everything lands in ``.tmp-step_<N>`` first — leaves, then the manifest
    (written last and fsynced, so a manifest's presence implies every leaf
    preceded it) — and one ``os.replace`` publishes the directory. A kill at
    any instant leaves either the previous checkpoint set untouched plus an
    ignorable ``.tmp-*`` orphan, or the complete new step; never a torn
    ``step_<N>`` that :func:`latest_step`/:func:`restore` would pick up.
    """
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    tmp = ckpt_dir / f".tmp-step_{step:08d}"
    final = ckpt_dir / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    host = [_to_host(leaf) for leaf in _flatten(state)]
    for i, (arr, dtype_str) in enumerate(host):
        _save_leaf(tmp / f"leaf_{i}.npy", arr, dtype_str)
    manifest = {
        "step": int(step),
        "treedef": _treedef(state),
        "n_leaves": len(host),
        "shapes": [list(a.shape) for a, _ in host],
        "dtypes": [d for _, d in host],
        "extras": extras or {},
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    _fsync(tmp / "manifest.json")
    if final.exists():  # re-saving a step: replace the whole directory
        shutil.rmtree(final)
    os.replace(tmp, final)  # atomic publish
    _fsync(ckpt_dir)  # the rename itself reaches stable storage
    _retain(ckpt_dir, keep)
    return final


def validate_step_dir(d: Path) -> str | None:
    """Why ``d`` is NOT a complete checkpoint, or None when it is.

    Checks the manifest parses with the expected keys and that every leaf
    file it names exists with a genuine ``.npy`` header — cheap (no array
    data is read), so recovery can scan a whole checkpoint directory.
    """
    mf = Path(d) / "manifest.json"
    if not mf.exists():
        return "missing manifest.json"
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, json.JSONDecodeError) as e:
        return f"unreadable manifest.json ({e})"
    for key in ("step", "n_leaves", "shapes", "dtypes"):
        if key not in manifest:
            return f"manifest missing {key!r}"
    try:
        n = int(manifest["n_leaves"])
    except (TypeError, ValueError):
        return "manifest n_leaves is not an integer"
    for i in range(n):
        leaf = Path(d) / f"leaf_{i}.npy"
        try:
            with open(leaf, "rb") as f:
                if f.read(len(_NPY_MAGIC)) != _NPY_MAGIC:
                    return f"leaf_{i}.npy is not a numpy file"
        except OSError:
            return f"missing leaf_{i}.npy"
    return None


def _step_dirs(ckpt_dir: Path) -> list[tuple[int, Path]]:
    return sorted(
        (int(m.group(1)), p)
        for p in ckpt_dir.iterdir()
        if (m := _STEP_RE.match(p.name))
    )


def complete_steps(ckpt_dir) -> list[int]:
    """Validated checkpoint steps, ascending; warns on torn directories."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    out = []
    for step, p in _step_dirs(ckpt_dir):
        defect = validate_step_dir(p)
        if defect is None:
            out.append(step)
        else:
            warnings.warn(f"skipping torn checkpoint {p}: {defect}", stacklevel=2)
    return out


def latest_step(ckpt_dir) -> int | None:
    steps = complete_steps(ckpt_dir)
    return steps[-1] if steps else None


def _load_step(d: Path, template, device):
    manifest = json.loads((d / "manifest.json").read_text())
    leaves = _flatten(template)
    assert manifest["n_leaves"] == len(leaves), (
        f"checkpoint has {manifest['n_leaves']} leaves, template {len(leaves)}"
    )
    loaded = [
        _decode(np.load(d / f"leaf_{i}.npy"), manifest["dtypes"][i])
        for i in range(len(leaves))
    ]
    for got, want in zip(loaded, leaves):
        shape = tuple(want.shape) if hasattr(want, "shape") else np.shape(want)
        assert tuple(got.shape) == tuple(shape), (tuple(got.shape), shape)
    out = []
    for got, want in zip(loaded, leaves):
        dev = device if device is not None else (
            want.device if isinstance(want, torch.Tensor) else "cpu")
        out.append(got.to(dtype=_dtype_of(want)).to(dev))
    return _unflatten(template, out), manifest["extras"]


def restore(ckpt_dir, template, step: int | None = None, device=None):
    """Restore into the structure of ``template``; returns (state, extras).

    Every leaf comes back as a torch tensor of the template leaf's dtype,
    on ``device`` when given, else on the template tensor's device (the CPU
    for numpy leaves) — the elastic-restore path: the restoring run may
    place it elsewhere than the saving one did. With ``step=None`` the
    newest *complete* checkpoint wins; steps whose manifest fails
    validation — or whose leaves fail to load — are skipped with a warning
    and recovery falls back to the next-newest, so one torn directory never
    aborts a restart. An explicit ``step`` that is torn raises
    :class:`CheckpointError`.
    """
    ckpt_dir = Path(ckpt_dir)
    if step is not None:
        d = ckpt_dir / f"step_{step:08d}"
        defect = validate_step_dir(d)
        if defect is not None:
            raise CheckpointError(f"checkpoint {d} is torn: {defect}")
        return _load_step(d, template, device)
    for s in reversed(complete_steps(ckpt_dir)):
        d = ckpt_dir / f"step_{s:08d}"
        try:
            return _load_step(d, template, device)
        # Template mismatches (AssertionError) are caller bugs and propagate;
        # only data-level corruption past the header check falls back.
        except (OSError, ValueError, KeyError, json.JSONDecodeError) as e:
            warnings.warn(
                f"checkpoint {d} failed to load ({e!r}); "
                "falling back to the previous step", stacklevel=2,
            )
    raise FileNotFoundError(f"no complete checkpoint in {ckpt_dir}")


def _snapshot(tree):
    """A host copy of ``tree``: every tensor on the CPU, every array copied."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    return np.array(tree)


class AsyncCheckpointer:
    """Snapshot synchronously, write in the background; at most one in flight.

    A failed background save is never swallowed: the exception is captured
    and re-raised (wrapped in :class:`CheckpointError`) from the NEXT
    ``save()`` or ``wait()`` call. ``wait(timeout=...)`` returns False if
    the writer is still running when the timeout expires, so shutdown stays
    bounded even when the filesystem hangs.
    """

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def _write(self, step, state, extras):
        try:
            save(self.ckpt_dir, step, state, extras, self.keep)
        except BaseException as e:  # noqa: BLE001 - must cross the thread
            self._exc = e

    def save(self, step: int, state, extras: dict | None = None):
        self.wait()
        # device -> host snapshot here (synchronously: a consistent view)
        self._thread = threading.Thread(
            target=self._write, args=(step, _snapshot(state), extras), daemon=True
        )
        self._thread.start()

    def wait(self, timeout: float | None = None) -> bool:
        """Join the in-flight save; re-raise its failure if it had one.

        Returns True when no save is left in flight; False when ``timeout``
        expired with the writer still running (the thread is left alone — a
        later ``wait()`` can still collect it).
        """
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                return False
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise CheckpointError(
                f"background checkpoint save failed: {exc!r}"
            ) from exc
        return True


def _retain(ckpt_dir: Path, keep: int):
    steps = sorted(
        int(m.group(1))
        for p in ckpt_dir.iterdir()
        if (m := _STEP_RE.match(p.name))
    )
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(ckpt_dir / f"step_{s:08d}", ignore_errors=True)
