"""Tree checkpoints in the reference's msgpack file format (port of
``repro.checkpoint.ckpt``).

A checkpoint is one msgpack map ``{"step", "treedef", "leaves": [{"dtype",
"shape", "data"}]}``: ``data`` holds a leaf's raw bytes, and the leaves
come in the reference's flatten order (dict keys sorted, a NamedTuple
such as ``AdamState`` field by field: step, mu, nu). ``treedef`` is the
string JAX gives the tree's structure (``str(PyTreeDef)``), so a file
written by either package loads through the other's
``load_checkpoint``. The trainer writes
``bridge.state_to_numpy(state)``, so a file holds the reference's
layouts (HWIO kernels) and its leaves decode with ``msgpack`` and the
reference's ``_unpack_leaf``.

Leaves may also be torch tensors (the LM's parameters, which keep the
reference's layouts): they are written from the host, and a bfloat16
leaf as its raw 16-bit words under the reference's dtype name
``"bfloat16"``, which numpy cannot name without ``ml_dtypes``. Loading
onto a template of tensors gives tensors with the template's dtype and
device; a ``"bfloat16"`` leaf is read as 16-bit words and viewed as
``torch.bfloat16``, bit for bit.

msgpack itself is not a dependency: a small encoder and decoder of the
types a checkpoint uses (map, str, int, array, bin) write and read the
same bytes ``msgpack.packb(payload, use_bin_type=True)`` gives.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Callable, Iterator, List, Tuple

import numpy as np
import torch


# ---------------------------------------------------------------------------
# msgpack subset: map, str, int, array, bin (the smallest form of each)
# ---------------------------------------------------------------------------

def _pack(obj: Any, write: Callable[[bytes], Any]) -> None:
    if isinstance(obj, bool):
        raise TypeError("checkpoint payloads hold no booleans")
    if isinstance(obj, int):
        _pack_int(obj, write)
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _pack_len(len(b), write, 0xa0, 32, (0xd9, 0xda, 0xdb))
        write(b)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        b = bytes(obj)
        _pack_len(len(b), write, None, 0, (0xc4, 0xc5, 0xc6))
        write(b)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), write, 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, write)
    elif isinstance(obj, dict):
        _pack_len(len(obj), write, 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, write)
            _pack(v, write)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__} into a checkpoint")


def _pack_len(n: int, write, fix_tag, fix_limit: int, tags) -> None:
    """A length header: the fix form below ``fix_limit``, else the 8-,
    16- or 32-bit form (a ``None`` tag has no such form)."""
    if fix_tag is not None and n < fix_limit:
        write(bytes([fix_tag | n]))
    elif tags[0] is not None and n < 1 << 8:
        write(struct.pack(">BB", tags[0], n))
    elif n < 1 << 16:
        write(struct.pack(">BH", tags[1], n))
    elif n < 1 << 32:
        write(struct.pack(">BI", tags[2], n))
    else:
        raise ValueError(f"length {n} exceeds msgpack's 32-bit lengths")


def _pack_int(v: int, write) -> None:
    if 0 <= v < 0x80:
        write(bytes([v]))
    elif -32 <= v < 0:
        write(struct.pack(">b", v))
    elif v >= 0:
        for tag, fmt, lim in ((0xcc, ">BB", 1 << 8), (0xcd, ">BH", 1 << 16),
                              (0xce, ">BI", 1 << 32), (0xcf, ">BQ", 1 << 64)):
            if v < lim:
                write(struct.pack(fmt, tag, v))
                return
        raise ValueError(f"int {v} exceeds 64 bits")
    else:
        for tag, fmt, lim in ((0xd0, ">Bb", 1 << 7), (0xd1, ">Bh", 1 << 15),
                              (0xd2, ">Bi", 1 << 31), (0xd3, ">Bq", 1 << 63)):
            if v >= -lim:
                write(struct.pack(fmt, tag, v))
                return
        raise ValueError(f"int {v} exceeds 64 bits")


def packb(obj: Any) -> bytes:
    """``obj`` encoded as msgpack (maps, str, int, arrays, bin)."""
    parts: List[bytes] = []
    _pack(obj, parts.append)
    return b"".join(parts)


_UINTS = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
          0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LENS = {0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
         0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
         0xdc: (">H", "array"), 0xdd: (">I", "array"),
         0xde: (">H", "map"), 0xdf: (">I", "map")}


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object made of the types ``packb`` writes."""
    buf = memoryview(data)
    obj, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"{len(buf) - end} trailing bytes after the object")
    return obj


def _unpack(buf: memoryview, i: int) -> Tuple[Any, int]:
    tag = buf[i]
    i += 1
    if tag < 0x80:
        return tag, i
    if tag >= 0xe0:
        return tag - 0x100, i
    if 0xa0 <= tag <= 0xbf:
        kind, n = "str", tag & 0x1f
    elif 0x90 <= tag <= 0x9f:
        kind, n = "array", tag & 0x0f
    elif 0x80 <= tag <= 0x8f:
        kind, n = "map", tag & 0x0f
    elif tag in _UINTS:
        fmt = _UINTS[tag]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, i)[0], i + size
    elif tag in _LENS:
        fmt, kind = _LENS[tag]
        n = struct.unpack_from(fmt, buf, i)[0]
        i += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type 0x{tag:02x} is not used by "
                         "checkpoints")
    if kind == "str":
        return str(buf[i:i + n], "utf-8"), i + n
    if kind == "bin":
        return bytes(buf[i:i + n]), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _unpack(buf, i)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _unpack(buf, i)
        out[k], i = _unpack(buf, i)
    return out, i


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_flatten(tree: Any) -> Tuple[List[Any], str]:
    """(leaves, structure) in JAX's flatten order, with the structure
    written as ``str(jax.tree_util.tree_flatten(tree)[1])`` writes it:
    dicts with sorted keys, a NamedTuple such as ``AdamState`` as
    ``CustomNode(namedtuple[Name], [...])``, lists, tuples (``(*,)`` for
    one element), ``None`` as a node without leaves, anything else a
    leaf ``*``."""
    leaves: List[Any] = []

    def walk(t) -> str:
        if t is None:
            return "None"
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}"
                                   for k in sorted(t)) + "}"
        if _is_namedtuple(t):
            return (f"CustomNode(namedtuple[{type(t).__name__}], ["
                    + ", ".join(walk(v) for v in t) + "])")
        if isinstance(t, list):
            return "[" + ", ".join(walk(v) for v in t) + "]"
        if isinstance(t, tuple):
            inner = ", ".join(walk(v) for v in t)
            return "(" + inner + ("," if len(t) == 1 else "") + ")"
        leaves.append(t)
        return "*"
    return leaves, f"PyTreeDef({walk(tree)})"


def _unflatten(template: Any, leaves: Iterator[Any]) -> Any:
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if _is_namedtuple(template):
        return type(template)(*(_unflatten(v, leaves) for v in template))
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _pack_leaf(x) -> dict:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return {"dtype": "bfloat16", "shape": list(t.shape),
                    "data": t.view(torch.int16).numpy().tobytes()}
        x = t.numpy()
    arr = np.asarray(x)
    return {"dtype": str(arr.dtype), "shape": list(arr.shape),
            "data": arr.tobytes()}


def _unpack_leaf(d: dict) -> np.ndarray:
    """A leaf as numpy; ``"bfloat16"`` comes back as its int16 words."""
    dtype = np.int16 if d["dtype"] == "bfloat16" else np.dtype(d["dtype"])
    return np.frombuffer(d["data"], dtype=dtype).reshape(d["shape"])


def _to_template(d: dict, got: np.ndarray, want):
    """A loaded leaf in the template leaf's type, dtype and device."""
    if isinstance(want, torch.Tensor):
        t = torch.from_numpy(got.copy())
        if d["dtype"] == "bfloat16":
            t = t.view(torch.bfloat16)
        return t.to(device=want.device, dtype=want.dtype)
    dtype = np.asarray(want).dtype
    if d["dtype"] == "bfloat16":
        if dtype.name != "bfloat16":
            raise ValueError("a bfloat16 leaf loads onto a tensor or a "
                             f"bfloat16 template, not {dtype}")
        return got.view(dtype).copy()
    return np.array(got, dtype=dtype)


def save_checkpoint(path: str, tree: Any, *, step: int = 0) -> None:
    """Write ``tree`` (numpy leaves, e.g. ``bridge.state_to_numpy`` of a
    trainer's state, or tensors) to ``path``, through a temporary
    file."""
    leaves, desc = tree_flatten(tree)
    payload = {"step": int(step), "treedef": desc,
               "leaves": [_pack_leaf(x) for x in leaves]}
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        _pack(payload, f.write)
    os.replace(tmp, path)


def load_checkpoint(path: str, template: Any) -> Tuple[Any, int]:
    """Returns (tree shaped like ``template``, step). The structure, the
    leaf count and every leaf's shape must match the template's, or it
    raises ``ValueError``; leaves take the template's dtypes (and, for
    tensors, its devices)."""
    with open(path, "rb") as f:
        payload = unpackb(f.read())
    t_leaves, desc = tree_flatten(template)
    if desc != payload["treedef"]:
        raise ValueError("checkpoint treedef mismatch")
    if len(payload["leaves"]) != len(t_leaves):
        raise ValueError("checkpoint leaf count mismatch")
    out = []
    for d, want in zip(payload["leaves"], t_leaves):
        got = _unpack_leaf(d)
        shape = tuple(want.shape if isinstance(want, torch.Tensor)
                      else np.shape(want))
        if tuple(got.shape) != shape:
            raise ValueError(f"shape mismatch {got.shape} vs {shape}")
        out.append(_to_template(d, got, want))
    return _unflatten(template, iter(out)), payload["step"]
