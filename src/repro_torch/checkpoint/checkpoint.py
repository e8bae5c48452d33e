"""Port of ``repro.checkpoint.checkpoint``: trees <-> one ``.npz`` + a manifest.

The file format is the reference's, byte for byte in its keys and arrays,
so a checkpoint written by either package loads in the other.  Leaves are
copied to the host (a torch tensor through ``detach().cpu()``, anything
else through ``np.asarray``).  The tree structure is encoded as flattened
key paths, so checkpoints are stable across Python versions and pickle no
code.

The reference walks trees with ``jax.tree_util``; this copy walks nested
``dict``, ``list``, ``tuple`` and ``NamedTuple`` itself and names the
leaves as JAX's path walk does: a dict key as ``str(key)``, with the keys
of every dict in sorted order; a list or tuple index as ``str(index)``; a
named-tuple field by its name, in field order; the parts joined by ``/``
(``rounds/0/msg/2/w``, ``ensemble/0/atom1/b``).  ``None`` is an empty
subtree, as in JAX.  ``tree_leaves`` gives the leaves in that order, which
is the order ``jax.tree_util.tree_leaves`` gives for the same tree.

Robustness contract:

* every write is atomic (temp file in the same directory + ``os.replace``
  after ``fsync``) — a reader never observes a half-written file;
* every read validates the embedded ``__manifest__`` and materialises all
  arrays before returning — a truncated/corrupt file raises a loud
  :class:`CheckpointError`, never returns garbage;
* ``CheckpointManager`` keeps an atomic ``LATEST`` pointer beside the
  rotation and falls back to the previous rotation entry when the newest
  checkpoint is corrupt, so a crash *during* a checkpoint write cannot
  strand a resume.

``CheckpointManager`` is what ``launch/train.py`` uses for the bit-exact
resume path; ``load_flat`` is the raw flat-dict loader for
:class:`~repro_torch.core.distributed.DistributedTrainer` state (whose
replay arrays have grown shapes no fresh ``like`` tree can predict).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
from typing import Any, Callable, Iterator

import numpy as np
import torch

PyTree = Any
_SEP = "/"
LATEST_NAME = "LATEST"


class CheckpointError(RuntimeError):
    """A checkpoint file is missing pieces, truncated, or corrupt."""


# ---------------------------------------------------------------------------
# host RNG state <-> array (bit-exact numpy Generator resume)
# ---------------------------------------------------------------------------

def rng_state_to_array(rng: np.random.Generator) -> np.ndarray:
    """Serialize a PCG64 ``np.random.Generator`` to a uint64[6] array.

    Layout: [state_hi, state_lo, inc_hi, inc_lo, has_uint32, uinteger].
    The 128-bit ``state``/``inc`` integers are split into two uint64 words
    each; ``has_uint32``/``uinteger`` capture the cached half-draw so a
    restored generator continues the exact output stream mid-word.
    """
    st = rng.bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise CheckpointError(
            f"can only checkpoint PCG64 generators, got {st['bit_generator']}")
    mask = (1 << 64) - 1
    s, inc = st["state"]["state"], st["state"]["inc"]
    return np.array(
        [(s >> 64) & mask, s & mask, (inc >> 64) & mask, inc & mask,
         int(st["has_uint32"]), int(st["uinteger"])],
        dtype=np.uint64)


def rng_state_from_array(arr: np.ndarray) -> np.random.Generator:
    """Rebuild the ``np.random.Generator`` serialized by
    :func:`rng_state_to_array`."""
    a = np.asarray(arr, dtype=np.uint64)
    if a.shape != (6,):
        raise CheckpointError(f"rng state array has shape {a.shape}, want (6,)")
    hi = lambda i: int(a[i]) << 64  # noqa: E731
    rng = np.random.default_rng(0)
    rng.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": hi(0) | int(a[1]), "inc": hi(2) | int(a[3])},
        "has_uint32": int(a[4]),
        "uinteger": int(a[5]),
    }
    return rng


# ---------------------------------------------------------------------------
# tree walk / flatten / unflatten
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree: PyTree, path: tuple[str, ...]) -> Iterator[tuple[tuple[str, ...], Any]]:
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from _walk(getattr(tree, name), path + (name,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    else:
        yield path, tree


def tree_leaves_with_paths(tree: PyTree) -> list[tuple[str, Any]]:
    """``[(key, leaf), ...]`` in ``jax.tree_util.tree_leaves`` order, keys
    as the reference writes them (``rounds/0/msg/2/w``)."""
    return [(_SEP.join(p), leaf) for p, leaf in _walk(tree, ())]


def tree_leaves(tree: PyTree) -> list[Any]:
    """The leaves of ``tree``, as they are, in ``jax.tree_util`` order."""
    return [leaf for _, leaf in _walk(tree, ())]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten_with_paths(tree: PyTree) -> dict[str, np.ndarray]:
    return {k: _to_numpy(leaf) for k, leaf in tree_leaves_with_paths(tree)}


def _rebuild(like: PyTree, path: tuple[str, ...], out: dict[str, np.ndarray]):
    if like is None:
        return None
    if isinstance(like, dict):
        return type(like)((k, _rebuild(like[k], path + (str(k),), out))
                          for k in like)
    if _is_namedtuple(like):
        return type(like)(*(_rebuild(getattr(like, n), path + (n,), out)
                            for n in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, path + (str(i),), out)
                          for i, v in enumerate(like))
    return out[_SEP.join(path)]


def _atomic_write(path: str, write_body: Callable[[Any], None]) -> None:
    """Write ``path`` atomically: mkstemp in the same directory, write,
    fsync, ``os.replace``.  The temp file is owned exactly once — an
    exception before ``fdopen`` takes ownership closes the raw fd, and the
    cleanup never unlinks a path that was already renamed into place (the
    old ``finally: if exists(tmp): unlink(tmp)`` form could delete a
    *racing writer's* fresh temp file of the same name after our rename)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        try:
            f = os.fdopen(fd, "wb")
        except Exception:
            os.close(fd)  # fdopen never took ownership
            raise
        with f:
            write_body(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        tmp = None  # renamed away — nothing left to clean up
    finally:
        if tmp is not None:
            try:
                os.unlink(tmp)
            except FileNotFoundError:
                pass


def save_pytree(path: str, tree: PyTree) -> None:
    """Save a pytree to ``path`` (.npz).  Atomic via temp-file rename +
    fsync; see :func:`_atomic_write` for the cleanup contract."""
    flat = _flatten_with_paths(tree)
    save_flat(path, flat)


def save_flat(path: str, flat: dict[str, np.ndarray]) -> None:
    """Save an already-flat ``{key: array}`` dict (keys may contain '/')."""
    for k in flat:
        if k == "__manifest__":
            raise ValueError("'__manifest__' is a reserved checkpoint key")
    manifest = np.frombuffer(json.dumps(sorted(flat)).encode(), dtype=np.uint8)
    arrays = {k: _to_numpy(v) for k, v in flat.items()}
    _atomic_write(path, lambda f: np.savez(f, __manifest__=manifest, **arrays))


def load_flat(path: str) -> dict[str, np.ndarray]:
    """Load the raw ``{key: array}`` dict saved by :func:`save_flat` /
    :func:`save_pytree`.

    Validates the embedded ``__manifest__`` (it must parse and its key set
    must match the archive's) and materialises EVERY array before
    returning, so a truncated or bit-flipped file raises
    :class:`CheckpointError` instead of surfacing garbage downstream.
    ``FileNotFoundError`` passes through untouched (absent != corrupt).
    """
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    try:
        with np.load(path) as data:
            if "__manifest__" not in data:
                raise CheckpointError(f"{path}: missing __manifest__")
            keys = json.loads(bytes(data["__manifest__"]).decode())
            if not isinstance(keys, list):
                raise CheckpointError(f"{path}: malformed __manifest__")
            present = set(data.files) - {"__manifest__"}
            if set(keys) != present:
                raise CheckpointError(
                    f"{path}: manifest/content mismatch "
                    f"(missing {sorted(set(keys) - present)[:4]}, "
                    f"extra {sorted(present - set(keys))[:4]})")
            # np.load is lazy — force every array through the decompressor
            # so truncation anywhere in the archive is caught HERE.
            return {k: np.asarray(data[k]) for k in keys}
    except CheckpointError:
        raise
    except Exception as e:  # BadZipFile, EOFError, OSError, ValueError, ...
        raise CheckpointError(f"{path}: corrupt checkpoint ({e!r})") from e


def unflatten_like(flat: dict[str, np.ndarray], like: PyTree) -> PyTree:
    """Rebuild a pytree with the structure of ``like`` from a flat dict
    (shape validated leaf-by-leaf, dtype cast to ``like``'s).  Leaves come
    back as numpy arrays."""
    out = {}
    for key, ref in _flatten_with_paths(like).items():
        if key not in flat:
            raise CheckpointError(f"checkpoint missing leaf {key!r}")
        arr = flat[key]
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointError(
                f"leaf {key!r}: checkpoint shape {arr.shape} != {ref.shape}")
        out[key] = arr.astype(ref.dtype)
    return _rebuild(like, (), out)


def load_pytree(path: str, like: PyTree) -> PyTree:
    """Load a pytree saved by :func:`save_pytree` into the structure of
    ``like`` (manifest-validated; raises :class:`CheckpointError` on any
    corruption)."""
    return unflatten_like(load_flat(path), like)


class CheckpointManager:
    """Step-numbered checkpoints with rotation: ``<dir>/ckpt_<step>.npz``.

    A ``LATEST`` pointer file (atomic temp-file + ``os.replace`` write,
    same discipline as the checkpoints themselves) names the newest step;
    ``restore``/``restore_flat`` fall back through older rotation entries
    when the newest file turns out corrupt — a SIGKILL mid-write costs one
    checkpoint of progress, never the run.

    ``fault_plan`` (duck-typed: anything with ``check_call(site)``) lets
    the deterministic fault harness inject transient write failures;
    ``save`` retries up to ``save_retries`` times and raises
    :class:`CheckpointError` once exhausted.
    """

    def __init__(self, directory: str, max_to_keep: int = 3,
                 fault_plan=None, save_retries: int = 2):
        self.directory = directory
        self.max_to_keep = max_to_keep
        self.fault_plan = fault_plan
        self.save_retries = save_retries
        self.n_save_retries = 0
        os.makedirs(directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"ckpt_{step}.npz")

    def _steps(self) -> list[int]:
        steps = []
        for f in os.listdir(self.directory):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def _write_latest(self, step: int) -> None:
        _atomic_write(os.path.join(self.directory, LATEST_NAME),
                      lambda f: f.write(f"{step}\n".encode()))

    def save(self, step: int, tree: PyTree, *, flat: bool = False) -> str:
        """Write ``ckpt_<step>.npz``, update LATEST, rotate old entries.
        With ``flat=True``, ``tree`` is an already-flat ``{key: array}``
        dict (the ``DistributedTrainer.state_dict()`` form)."""
        path = self._path(step)
        writer = save_flat if flat else save_pytree
        attempt = 0
        while True:
            try:
                if self.fault_plan is not None:
                    self.fault_plan.check_call("checkpoint")
                writer(path, tree)
                break
            except Exception as e:  # noqa: BLE001 — injected or real I/O
                if attempt >= self.save_retries:
                    raise CheckpointError(
                        f"checkpoint write {path} failed after "
                        f"{attempt + 1} attempts: {e!r}") from e
                attempt += 1
                self.n_save_retries += 1
        self._write_latest(step)
        for old in self._steps()[: -self.max_to_keep]:
            os.unlink(self._path(old))
        return path

    def latest_step(self) -> int | None:
        """Newest step per the LATEST pointer; falls back to a directory
        scan when the pointer is absent/stale/corrupt."""
        steps = self._steps()
        latest = os.path.join(self.directory, LATEST_NAME)
        try:
            with open(latest, "rb") as f:
                step = int(f.read().strip())
            if step in steps:
                return step
        except (FileNotFoundError, ValueError):
            pass
        return steps[-1] if steps else None

    def _restore_any(self, step: int | None, loader):
        if step is not None:
            return step, loader(self._path(step))
        candidates = self._steps()
        latest = self.latest_step()
        if latest is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        # newest first, LATEST pointer wins ties with the scan order
        ordered = [latest] + [s for s in reversed(candidates) if s != latest]
        last_err: Exception | None = None
        for s in ordered:
            try:
                return s, loader(self._path(s))
            except (CheckpointError, FileNotFoundError) as e:
                last_err = e
        raise CheckpointError(
            f"all checkpoints in {self.directory} are corrupt "
            f"(last error: {last_err!r})") from last_err

    def restore(self, like: PyTree, step: int | None = None) -> tuple[int, PyTree]:
        return self._restore_any(step, lambda p: load_pytree(p, like))

    def restore_flat(self, step: int | None = None) -> tuple[int, dict[str, np.ndarray]]:
        """Restore the raw flat dict of the newest readable checkpoint."""
        return self._restore_any(step, load_flat)
