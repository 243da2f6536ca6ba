"""Checkpointing with async writes, in the reference's on-disk format.

Format: one directory ``step_%08d/`` per step containing
  - ``meta.json``          step, tree signature, process index
  - ``arrays.npz``         flattened tree, keys are '/'-joined paths

Tensors are copied to host memory before :meth:`Checkpointer.save`
returns (a CUDA tensor's ``.cpu()`` waits for the stream that made it);
a background thread then writes only those host arrays, so the ingest
loop never blocks on I/O and no device copy races the writer.  Writes go
through a ``.tmp`` directory and a rename; the last ``keep`` steps are
kept.

Beyond dict/list/tuple trees, a container is checkpointable as-is when it
is one of the port's three containers with a reference twin, or any
dataclass exposing ``tree_flatten() -> (children, aux)`` and a class
method ``tree_unflatten(aux, children)``.  Save expands it into its
children plus two marker leaves (``__type__``: the type name, ``__aux__``:
the static aux data as JSON) and restore rebuilds the same object.
Children may be arrays, ``None`` (round-trips through a string
sentinel), non-empty dicts, or nested containers; bare list/tuple and
empty-dict children are rejected at save time (neither would survive the
string-keyed rebuild).

**Files cross between the packages in both directions.**  The three
containers are written under the REFERENCE's type names, with its child
and aux layout:

======================================  ======================================
port class                              ``__type__`` written
======================================  ======================================
``stream.state.StreamingSVDState``      ``repro.stream.state:StreamingSVDState``
``core.sparse.BlockEll``                ``repro.core.sparse:BlockEll``
``core.sparse.RepairedSparseBlocks``    ``repro.core.sparse:RepairedSparseBlocks``
======================================  ======================================

and :meth:`Checkpointer.restore` resolves those names through the same
table: it never imports a module of the reference package (that would
load JAX).  Any other ``repro.*`` name raises ``TypeError``; other names
resolve by import, as in the reference.  The state's integer ``seed`` is
written as the reference's ``key = PRNGKey(seed)``, a ``uint32[2]`` array
``[seed >> 32, seed & 0xFFFFFFFF]`` (exactly ``PRNGKey(seed)`` for every
seed below 2**32), and read back as ``hi << 32 | lo``; a train state's seed
is written the same way, as its ``rng`` (``train/step.checkpoint_tree``).
Resume is
bit-identical within a package; across the packages the random draws of
later batches differ by design (randomness is an input).

Signatures hash numpy dtype names (``float32``, ``int32``, ``bool``,
``uint32``), so a port tree and a reference tree of the same shapes and
counters sign the same and ``expect_signature`` works across the two.

**Sharded states.**  Files are saved gathered: a state sharded over a
process group has its ``v`` all-gathered at save (every rank calls
``save``; rank 0 writes), so the on-disk layout never bakes in a mesh.
``restore(shardings=)`` places the tree over a block mesh (a
``core.collectives.BlockMesh``, or a dict of them keyed like the tree):
a state of as many column blocks as the mesh has slots comes back
sharded, any other onto the mesh's device gathered; a file saved on 8
slots restores onto 1, and the other way round.  Without ``shardings``
a rebuilt state re-shards itself onto the active stream pool when that
has one slot a block (``StreamingSVDState.reshard_for_restore``).

An LM train state on the model mesh (``ctx``, ``models/layers.ShardCtx``)
holds each rank's blocks; ``save(shardings=, ctx=)`` takes its spec tree
(``train.step.state_shardings``), gathers every leaf to its full value
(every rank calls it) and rank 0 writes, so the file is the one device's,
format and signature included; ``restore(shardings=, ctx=)`` reads the
file and keeps each rank's block.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib
import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import collectives, sparse
from repro_torch.stream import state as stream_state
from repro_torch.stream.state import StreamingSVDState

# String sentinels for things npz cannot carry natively.  They live in
# ordinary unicode arrays, so no pickling is ever needed on load.
_TYPE_KEY = "__type__"
_AUX_KEY = "__aux__"
_NONE_SENTINEL = "__none__"
_U32 = 0xFFFFFFFF


def _seed_to_key(seed: int) -> np.ndarray:
    """An integer seed as the reference's ``uint32[2]`` key (exactly
    ``PRNGKey(seed)`` below 2**32)."""
    if not 0 <= seed < 1 << 64:
        raise ValueError(
            f"checkpointing a seed: {seed} does not fit the reference's "
            f"uint32[2] key (0 <= seed < 2**64)")
    return np.array([seed >> 32, seed & _U32], dtype=np.uint32)


def _key_to_seed(key) -> int:
    hi, lo = (int(x) for x in _host(key).reshape(-1))
    return hi << 32 | lo


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@dataclasses.dataclass(frozen=True)
class _Twin:
    """How a port container is written under its reference twin's name."""

    name: str
    flatten: Callable[[Any], Tuple[tuple, tuple]]
    unflatten: Callable[[tuple, tuple], Any]


def _state_flatten(st: StreamingSVDState):
    if st.sharded_rows:
        st = stream_state.gather_state(st)
    return ((st.u, st.s, st.v, _seed_to_key(st.seed)),
            (st.n, st.num_blocks, st.rows_seen, st.batches_seen,
             st.lonely_rows_seen, st.repaired_rows_seen))


def _state_unflatten(aux, children) -> StreamingSVDState:
    u, s, v, key = children
    return StreamingSVDState(u, s, v, _key_to_seed(key), *aux)


_TWINS: Dict[type, _Twin] = {
    StreamingSVDState: _Twin(
        "repro.stream.state:StreamingSVDState", _state_flatten,
        _state_unflatten),
    sparse.BlockEll: _Twin(
        "repro.core.sparse:BlockEll",
        lambda e: ((e.col_ids, e.col_rows, e.col_vals),
                   (e.m, e.width, e.n, e.nnz)),
        lambda aux, ch: sparse.BlockEll(*ch, *aux)),
    sparse.RepairedSparseBlocks: _Twin(
        "repro.core.sparse:RepairedSparseBlocks",
        lambda r: ((r.ell, r.repair_cols, r.repair_mask), ()),
        lambda aux, ch: sparse.RepairedSparseBlocks(*ch)),
}
_TWIN_BY_NAME = {tw.name: tw for tw in _TWINS.values()}


def _is_pytree_dataclass(node) -> bool:
    return (dataclasses.is_dataclass(node) and not isinstance(node, type)
            and hasattr(node, "tree_flatten")
            and hasattr(type(node), "tree_unflatten"))


def _resolve_unflatten(spec: str) -> Callable[[tuple, tuple], Any]:
    """The rebuild function of a ``module:QualName`` type name: a twin's
    from the table, else the imported class's ``tree_unflatten``."""
    twin = _TWIN_BY_NAME.get(spec)
    if twin is not None:
        return twin.unflatten
    module, _, qual = spec.partition(":")
    if module == "repro" or module.startswith("repro."):
        raise TypeError(
            f"checkpoint holds a {spec!r}, a type of the reference package "
            f"with no counterpart here (the port restores "
            f"{sorted(_TWIN_BY_NAME)}); importing it would load JAX")
    obj = importlib.import_module(module)
    for part in qual.split("."):
        obj = getattr(obj, part)
    return obj.tree_unflatten


def _flatten(tree) -> Dict[str, Any]:
    flat = {}

    def rec(node, path):
        if isinstance(node, dict):
            for k in (_TYPE_KEY, _AUX_KEY):
                if k in node:
                    raise ValueError(
                        f"checkpoint tree dict at {'/'.join(path) or '<root>'} "
                        f"uses the reserved key {k!r} (it marks registered "
                        f"pytree dataclasses on restore); rename it")
            for k, v in node.items():
                rec(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                rec(v, path + (str(i),))
        elif type(node) in _TWINS or _is_pytree_dataclass(node):
            twin = _TWINS.get(type(node))
            t = type(node)
            if twin is not None:
                children, aux = twin.flatten(node)
                name = twin.name
            else:
                children, aux = node.tree_flatten()
                name = f"{t.__module__}:{t.__qualname__}"
            for i, c in enumerate(children):
                # A list/tuple child would flatten into numeric
                # sub-keys and restore as a string-keyed dict handed
                # straight to tree_unflatten, and an EMPTY dict child
                # emits no keys at all (restore would miscount the
                # children) — reject both loudly instead of writing a
                # checkpoint that cannot restore.
                if isinstance(c, (list, tuple)) or \
                        (isinstance(c, dict) and not c):
                    raise TypeError(
                        f"checkpointing {t.__qualname__}: child {i} is "
                        f"{'an empty dict' if isinstance(c, dict) else 'a ' + type(c).__name__}; "
                        f"pytree-dataclass children must be arrays, "
                        f"None, non-empty dicts, or registered "
                        f"dataclasses (wrap sequences in a dict)")
            # Marker leaves are written directly (the dict branch above
            # rejects these reserved keys in USER dicts).
            flat["/".join(path + (_TYPE_KEY,))] = name
            flat["/".join(path + (_AUX_KEY,))] = json.dumps(list(aux))
            for i, c in enumerate(children):
                rec(c, path + (f"c{i}",))
        else:
            flat["/".join(path)] = node

    rec(tree, ())
    return flat


def _unflatten(flat: Dict[str, Any]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _rebuild(node, reshard: bool = True):
    """Reconstruct the containers (bottom-up) from the marker dicts
    ``_flatten`` wrote."""
    if not isinstance(node, dict):
        return node
    if _TYPE_KEY in node:
        unflatten = _resolve_unflatten(str(node[_TYPE_KEY]))
        aux = tuple(json.loads(str(node[_AUX_KEY])))
        n_children = len(node) - 2
        children = tuple(_rebuild(node[f"c{i}"], reshard)
                         for i in range(n_children))
        obj = unflatten(aux, children)
        # A rebuilt container may opt into re-placing itself for the
        # current device environment (the streaming state re-shards onto
        # the active stream pool when that has one slot a block).
        hook = getattr(obj, "reshard_for_restore", None)
        return hook() if reshard and callable(hook) else obj
    return {k: _rebuild(v, reshard) for k, v in node.items()}


def _np_dtype_name(dtype: torch.dtype, where: str) -> str:
    try:
        return str(torch.empty((), dtype=dtype).numpy().dtype)
    except TypeError:
        raise TypeError(
            f"checkpoint leaf {where or '<root>'} has dtype {dtype}, which "
            f"numpy (and so the npz format) cannot hold; cast it first")


def _encode_leaf(key: str, v) -> np.ndarray:
    if v is None:
        return np.asarray(_NONE_SENTINEL)
    if isinstance(v, torch.Tensor):
        _np_dtype_name(v.dtype, key)
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _decode_leaf(v):
    if (isinstance(v, np.ndarray) and v.dtype.kind == "U" and v.ndim == 0
            and str(v) == _NONE_SENTINEL):
        return None
    return v


def _spec_map(fn, tree, shardings):
    """``fn(leaf, spec)`` over the tensors of ``tree`` by ``shardings`` (a
    spec tree: nested dicts, specs as tuples); a tensor it does not name
    takes the spec ``()`` (whole)."""
    if isinstance(tree, dict):
        sub = shardings if isinstance(shardings, dict) else {}
        return {k: _spec_map(fn, v, sub.get(k)) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fn(tree, shardings if isinstance(shardings, tuple) else ())
    return tree


def _sharded(shardings, ctx) -> bool:
    return ctx is not None and ctx.mesh is not None and shardings is not None


def tree_signature(tree, *, shardings=None, ctx=None) -> str:
    """Structure hash: array shapes / numpy dtype names plus — for the
    containers — the type and aux CONTENT (aux is static structure, so
    e.g. a state with different counters signs differently, deliberately;
    string leaves hash by value).  A port tree signs the same as the
    reference tree it is written as.  A tree of a rank's blocks
    (``shardings`` and ``ctx``) signs as its full value."""
    if _sharded(shardings, ctx):
        def full(x, spec):
            shape = [d * ctx.size(ax) for d, ax in zip(
                x.shape, tuple(spec) + (None,) * x.dim())]
            return torch.empty(shape, dtype=x.dtype, device="meta")
        tree = _spec_map(full, tree, shardings)
    flat = _flatten(tree)

    def desc(k, v):
        if v is None:
            return "None"
        if isinstance(v, str):
            return ["str", v]
        if isinstance(v, torch.Tensor):
            return [list(v.shape), _np_dtype_name(v.dtype, k)]
        return [list(np.shape(v)),
                str(np.asarray(v).dtype if not hasattr(v, "dtype")
                    else v.dtype)]

    text = json.dumps({k: desc(k, v) for k, v in sorted(flat.items())})
    return hashlib.sha1(text.encode()).hexdigest()[:16]


def _process_index() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


class Checkpointer:
    """Async checkpoint writer + restorer."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ----------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False,
             extra_meta: Optional[dict] = None, shardings=None,
             ctx=None) -> str:
        """Write ``tree`` as step ``step``; returns the step's directory.
        Every tensor is on the host before this returns; the file is
        written in the background unless ``blocking``.  A tree of a rank's
        blocks (``shardings``: its spec tree, ``ctx``: the mesh's
        ``ShardCtx``) is gathered first, every rank calling."""
        self.wait()
        if _sharded(shardings, ctx):
            tree = _spec_map(ctx.gather, tree, shardings)
        flat = _flatten(tree)
        host = {k: _encode_leaf(k, v) for k, v in flat.items()}
        path = os.path.join(self.directory, f"step_{step:08d}")
        meta = {
            "step": step,
            "signature": tree_signature(tree),
            "process_index": _process_index(),
            **(extra_meta or {}),
        }

        if meta["process_index"] != 0:
            # Every rank took part in the gathers above; one writes.
            return path

        def write():
            tmp = path + ".tmp"
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(path):
                shutil.rmtree(path)
            os.rename(tmp, path)
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()
        return path

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.list_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore -------------------------------------------------------
    def list_steps(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.list_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, *, device=None,
                expect_signature: Optional[str] = None,
                reshard: bool = True, shardings=None, ctx=None):
        """Load a checkpoint (the latest when ``step`` is None) onto
        ``device`` (``None``: the mesh's device when ``shardings`` is a
        mesh, else the GPU).  Returns ``(tree, meta)``.  ``shardings``
        places the tree over a block mesh (see the module docstring), or
        with ``ctx`` is a spec tree: each rank keeps its blocks;
        ``reshard=False`` skips a rebuilt container's own re-placement
        hook (``reshard_for_restore``)."""
        if device is None and isinstance(shardings, collectives.BlockMesh):
            device = shardings.device
        if device is None and ctx is not None and ctx.mesh is not None:
            device = ctx.mesh.device
        device = resolve_device(device)
        blocks = _sharded(shardings, ctx)
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if expect_signature and meta["signature"] != expect_signature:
            raise ValueError(
                f"checkpoint signature {meta['signature']} != expected "
                f"{expect_signature} (model/optimizer config changed?)")
        with np.load(os.path.join(path, "arrays.npz")) as arrs:
            flat = {k: _decode_leaf(arrs[k]) for k in arrs.files}

        def put(x):
            # Type/aux marker strings stay on the host; a rank's blocks
            # are cut on the host.
            if x is None or (isinstance(x, np.ndarray)
                             and x.dtype.kind == "U"):
                return x
            return torch.as_tensor(x, device="cpu" if blocks else device)

        tree = _unflatten({k: put(v) for k, v in flat.items()})
        # Rebuild the containers LAST, once every array child is placed
        # (markers are consumed here), then place them over the meshes.
        tree = _rebuild(tree, reshard)
        if blocks:
            return _spec_map(lambda x, sp: ctx.local(x, sp).to(
                device, copy=True), tree, shardings), meta
        return _place(tree, shardings), meta


def _place(node, sh):
    """``node`` placed by ``sh``: a BlockMesh for the whole subtree (a
    state of as many blocks as it has slots sharded over it, tensors onto
    its device), a dict of them by key, or None (as restored)."""
    if sh is None:
        return node
    if isinstance(sh, dict):
        if not isinstance(node, dict):
            raise ValueError(
                f"shardings is a dict but the restored node is a "
                f"{type(node).__name__}")
        return {k: _place(v, sh.get(k)) for k, v in node.items()}
    if not isinstance(sh, collectives.BlockMesh):
        raise TypeError(
            f"shardings takes BlockMesh leaves (LocalMesh / "
            f"ProcessGroupMesh) in dicts keyed like the tree; got "
            f"{type(sh)}")
    if isinstance(node, StreamingSVDState):
        if node.num_blocks == sh.size:
            return stream_state.shard_state(node, sh)
        return stream_state.gather_state(node, sh.device)
    if isinstance(node, dict):
        return {k: _place(v, sh) for k, v in node.items()}
    if isinstance(node, torch.Tensor):
        return node.to(sh.device)
    return node
