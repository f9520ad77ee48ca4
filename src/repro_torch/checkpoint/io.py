"""Pytree checkpoints in ``repro``'s file format — the port of
``repro.checkpoint.io``.

A file is one msgpack map from a leaf's path ("lora_server/0/mixer/q/a")
to ``{"dtype", "shape", "data"}`` (numpy dtype name, list of ints, raw
bytes).  ``save_episode``/``restore_episode`` wrap the same map with a
JSON metadata string: ``{"__tree__": map, "__meta__": json.dumps(meta)}``
— the round cursor, the fading / outage RNG cursors (a numpy PCG64 state
is a 128-bit int, which JSON carries and msgpack does not) and the
history, in one file and one atomic rename.

The trees are ``repro``-shaped: layers stacked over the repeat axis, as
``interop`` (``lora_to_numpy``, ``sfl_state_to_numpy``) gives them.
Leaves are flattened in ``jax.tree_util``'s order — dict keys sorted,
list and tuple items in order, dataclass fields in declaration order,
``None`` skipped — so the port writes the same bytes ``repro`` writes
for the same tree, and each package reads the other's files.  Leaves may
be numpy arrays or tensors; a restored leaf takes its template leaf's
kind, and a tensor its template's device.

msgpack itself is not a dependency: a small codec below writes and reads
the subset ``repro`` emits (maps, str, bin, arrays, non-negative ints),
choosing the encoding ``msgpack.packb(..., use_bin_type=True)`` chooses,
and raises ``ValueError`` on anything else.
"""
from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------


def _pack_len(out: bytearray, n: int, fix_base: int, fix_max: int,
              wide: Tuple[Tuple[int, int, str], ...]) -> None:
    """A header: a fix form below ``fix_max``, else the first wide form
    (limit, tag, struct code) that holds ``n``."""
    if fix_max and n <= fix_max:
        out.append(fix_base | n)
        return
    for limit, tag, code in wide:
        if n <= limit:
            out.append(tag)
            out += struct.pack(">" + code, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if isinstance(obj, bool) or not isinstance(obj, (int, str, bytes, list, tuple, dict)):
        raise ValueError(f"cannot encode {type(obj).__name__} (the checkpoint codec "
                         "writes maps, str, bin, arrays and non-negative ints)")
    if isinstance(obj, int):
        if obj < 0:
            raise ValueError(f"cannot encode negative int {obj}")
        _pack_len(out, obj, 0x00, 0x7F, ((0xFF, 0xCC, "B"), (0xFFFF, 0xCD, "H"),
                                         (0xFFFFFFFF, 0xCE, "I"),
                                         (0xFFFFFFFFFFFFFFFF, 0xCF, "Q")))
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 0x1F, ((0xFF, 0xD9, "B"), (0xFFFF, 0xDA, "H"),
                                              (0xFFFFFFFF, 0xDB, "I")))
        out += raw
    elif isinstance(obj, bytes):
        _pack_len(out, len(obj), 0, 0, ((0xFF, 0xC4, "B"), (0xFFFF, 0xC5, "H"),
                                        (0xFFFFFFFF, 0xC6, "I")))
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 0x0F, ((0xFFFF, 0xDC, "H"), (0xFFFFFFFF, 0xDD, "I")))
        for v in obj:
            _pack(v, out)
    else:
        _pack_len(out, len(obj), 0x80, 0x0F, ((0xFFFF, 0xDE, "H"), (0xFFFFFFFF, 0xDF, "I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)


def packb(obj: Any) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the codec's subset."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


_WIDE = {0xCC: ("int", "B"), 0xCD: ("int", "H"), 0xCE: ("int", "I"), 0xCF: ("int", "Q"),
         0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
         0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
         0xDC: ("array", "H"), 0xDD: ("array", "I"),
         0xDE: ("map", "H"), 0xDF: ("map", "I")}


def _unpack(buf: bytes, pos: int) -> Tuple[Any, int]:
    tag = buf[pos]
    pos += 1
    if tag <= 0x7F:
        return tag, pos
    if 0x80 <= tag <= 0x8F:
        kind, n = "map", tag & 0x0F
    elif 0x90 <= tag <= 0x9F:
        kind, n = "array", tag & 0x0F
    elif 0xA0 <= tag <= 0xBF:
        kind, n = "str", tag & 0x1F
    elif tag in _WIDE:
        kind, code = _WIDE[tag]
        size = struct.calcsize(">" + code)
        (n,) = struct.unpack_from(">" + code, buf, pos)
        pos += size
        if kind == "int":
            return n, pos
    else:
        raise ValueError(f"unsupported msgpack type byte 0x{tag:02x} at offset {pos - 1}")
    if kind == "str":
        return buf[pos:pos + n].decode("utf-8"), pos + n
    if kind == "bin":
        return bytes(buf[pos:pos + n]), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _unpack(buf, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        out[k], pos = _unpack(buf, pos)
    return out, pos


def unpackb(buf: bytes) -> Any:
    """Inverse of :func:`packb` (``msgpack.unpackb(buf, raw=False)``)."""
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after the msgpack object")
    return obj


# ---------------------------------------------------------------------------
# trees <-> flat maps
# ---------------------------------------------------------------------------

def _items(tree: Any):
    """(key, child) pairs of a container in jax.tree_util's order, or None
    for a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [(f.name, getattr(tree, f.name)) for f in dataclasses.fields(tree)]
    return None


def _paths(tree: Any, prefix: str = ""):
    """(path, leaf) of every non-None leaf, in flatten order."""
    if tree is None:
        return
    items = _items(tree)
    if items is None:
        yield prefix, tree
        return
    for k, v in items:
        yield from _paths(v, f"{prefix}/{k}" if prefix else k)


def _record(leaf: Any) -> dict:
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.uint16).numpy().tobytes()}
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return {"dtype": str(arr.dtype), "shape": [int(n) for n in arr.shape],
            "data": arr.tobytes()}


def _flatten(tree: Any) -> dict:
    return {k: _record(leaf) for k, leaf in _paths(tree)}


def _leaf(rec: dict, like: Any) -> Any:
    """One record -> a tensor on ``like``'s device when ``like`` is a
    tensor, else a numpy array (bf16 as ``ml_dtypes.bfloat16``)."""
    shape = tuple(rec["shape"])
    if rec["dtype"] == "bfloat16":
        raw = np.frombuffer(rec["data"], dtype=np.uint16).reshape(shape)
        if torch.is_tensor(like):
            return torch.from_numpy(raw.copy()).view(torch.bfloat16).to(like.device)
        import ml_dtypes
        return raw.view(ml_dtypes.bfloat16).copy()
    arr = np.frombuffer(rec["data"], dtype=rec["dtype"]).reshape(shape).copy()
    return torch.from_numpy(arr).to(like.device) if torch.is_tensor(like) else arr


def _unflatten(flat: dict, template: Any, prefix: str = "") -> Any:
    if template is None:
        # a None leaf (a state not allocated yet, e.g. the error-feedback
        # accumulators of a fresh SflState) takes the file's array if the
        # file holds one under its path
        return _leaf(flat[prefix], None) if prefix in flat else None
    items = _items(template)
    if items is None:
        if prefix not in flat:
            raise KeyError(f"checkpoint missing leaf {prefix!r}")
        return _leaf(flat[prefix], template)
    kids = {k: _unflatten(flat, v, f"{prefix}/{k}" if prefix else k) for k, v in items}
    if isinstance(template, dict):
        return {k: kids[str(k)] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(kids[str(i)] for i in range(len(template)))
    return dataclasses.replace(template, **kids)


def _atomic_write(path: str, payload: bytes) -> None:
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def _read(path: str) -> Any:
    with open(path, "rb") as f:
        return unpackb(f.read())


# ---------------------------------------------------------------------------
# the API of repro.checkpoint
# ---------------------------------------------------------------------------

def save_pytree(path: str, tree: Any) -> None:
    """Write ``tree`` (repro-shaped; numpy or tensor leaves) to ``path``."""
    _atomic_write(path, packb(_flatten(tree)))


def restore_pytree(path: str, template: Any) -> Any:
    """The tree saved at ``path``, in ``template``'s structure (shapes and
    dtypes come from the file).  A None in the template is filled with the
    file's array at that path, as numpy, where the file has one (``repro``
    keeps the None).  Reads the tree half of an episode file too."""
    flat = _read(path)
    if "__tree__" in flat:                      # episode file: device part
        flat = flat["__tree__"]
    return _unflatten(flat, template)


def save_episode(path: str, tree: Any, meta: dict) -> None:
    """One-file episode checkpoint: the tree (as :func:`save_pytree`) plus
    ``json.dumps(meta)``; ``meta`` must be JSON-serializable."""
    _atomic_write(path, packb({"__tree__": _flatten(tree), "__meta__": json.dumps(meta)}))


def restore_episode(path: str, template: Any) -> Tuple[Any, dict]:
    """Inverse of :func:`save_episode`: returns (tree, meta)."""
    payload = _read(path)
    if not isinstance(payload, dict) or "__tree__" not in payload \
            or "__meta__" not in payload:
        raise KeyError(f"{path!r} is not an episode checkpoint "
                       "(save_episode writes __tree__ + __meta__)")
    return _unflatten(payload["__tree__"], template), json.loads(payload["__meta__"])
