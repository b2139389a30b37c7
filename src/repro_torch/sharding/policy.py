"""Sharding policy: per-parameter partition specs and activation specs
(port of ``repro.sharding.policy``).

Rules are name-based with a divisibility-aware fallback: each parameter
kind lists candidate (dim -> mesh axis) placements, and an axis is
dropped when it does not evenly divide its dim (mixtral's 8 experts on
an 8-way model axis shard expert-parallel; on a 16-way one they fall
back to tensor parallelism over d_ff).

Axes:
  * ``data`` (and an outer ``pod`` where the mesh has one): the batch /
    FSDP axis;
  * ``model``: the tensor-parallel axis.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim,
each None, one axis name or a tuple of axis names (major first).
``to_placements`` maps it onto a ``torch.distributed`` ``DeviceMesh`` as
DTensor ``Shard``/``Replicate`` placements, one per mesh dim.

The host logic reads only the mesh's axis names and sizes: a
``DeviceMesh`` (``mesh_dim_names`` and ``shape``) or any object with
``axis_names`` and a name -> size mapping ``shape``, so specs can be
computed for a mesh no process group backs.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np


class PartitionSpec(tuple):
    """One entry per tensor dim: None, an axis name or a tuple of them."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclasses.dataclass(frozen=True)
class ShardingPolicy:
    fsdp: bool = True
    seq_parallel: bool = True       # shard seq over model axis between blocks
    shard_cache_seq: bool = True    # decode KV cache seq axis over model


def axis_names(mesh) -> Tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:                       # a DeviceMesh
        return tuple(names)
    return tuple(mesh.axis_names)


def axis_sizes(mesh) -> Dict[str, int]:
    """Mesh axis name -> number of ranks along it."""
    if getattr(mesh, "mesh_dim_names", None) is not None:
        return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape)))
    return {k: int(v) for k, v in dict(mesh.shape).items()}


def data_axes(mesh) -> Tuple[str, ...]:
    names = axis_names(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def sanitize(mesh, shape: Sequence[int], spec: Sequence) -> PartitionSpec:
    """Drop axes that don't divide their dim or don't exist in the mesh."""
    out = []
    sizes = axis_sizes(mesh)
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a in sizes)
        size = int(np.prod([sizes[a] for a in axes])) if axes else 1
        if axes and dim % size == 0 and size > 1:
            out.append(axes[0] if len(axes) == 1 else axes)
        else:
            out.append(None)
    return P(*out)


def client_axes(mesh, n_rows: int):
    """Mesh axes to shard a leading client/population axis over, or None.

    The stacked-client ("rows") axis shards over the data axes ('pod',
    'data') only when their product evenly divides ``n_rows``: a ragged
    split would leave shards with unequal row counts. Returns the
    sanitize-style spec entry (an axis name, a tuple of them, or None:
    no sharding, callers take the single-device path)."""
    return sanitize(mesh, (n_rows,), (data_axes(mesh),))[0]


def group_client_axes(mesh, group_sizes: Sequence[int]):
    """Mesh axes to shard *per-group* client stacks over, or None.

    The chunk-streamed round streams each profile group's ``[K_g, ...]``
    stack, so every group's rows must split evenly: a stricter condition
    than ``client_axes``'s total-row divisibility. The common spec entry
    when every group size divides by the data-axes product, else None
    (callers fall back to the unsharded stream)."""
    specs = {client_axes(mesh, int(s)) for s in group_sizes}
    if len(specs) == 1:
        return specs.pop()
    return None


def shard_index(mesh, axes) -> Tuple[int, int]:
    """(this rank's block index, the number of blocks) along the mesh
    axes ``axes`` (a name or a tuple of names, major first), as
    ``shard_map`` numbers the blocks of a dim sharded over them. Needs a
    ``DeviceMesh`` on which this rank holds a coordinate."""
    idx, count = 0, 1
    sizes = axis_sizes(mesh)
    for ax in ((axes,) if isinstance(axes, str) else tuple(axes)):
        idx = idx * sizes[ax] + mesh.get_local_rank(ax)
        count *= sizes[ax]
    return idx, count


def row_block(mesh, n_rows: int, axes) -> Tuple[int, int]:
    """[lo, hi) of the rows of a ``[n_rows, ...]`` stack that this rank
    holds when the stack's leading axis shards over ``axes`` (an entry of
    ``client_axes`` or ``group_client_axes``, which divides ``n_rows``);
    all of them for ``axes=None``. The federation rounds' row blocks and
    the client-sharded training step's rows both come from here."""
    if axes is None:
        return 0, int(n_rows)
    i, n = shard_index(mesh, axes)
    per = int(n_rows) // n
    return i * per, (i + 1) * per


def cohort_axes(mesh, bucket_sizes: Sequence[int]):
    """Mesh axes to shard bucket-padded serving-cohort rows over, or None.

    The split-serving engine pads each cut's request rows to a
    power-of-two bucket, so the row counts divide any power-of-two
    data-axes product whenever bucket >= mesh. The common spec entry
    when every bucket divides by the data-axes product, else None (the
    engine runs unsharded)."""
    specs = {client_axes(mesh, int(b)) for b in bucket_sizes}
    if len(specs) == 1:
        return specs.pop()
    return None


def client_stack_spec(mesh, shape: Sequence[int]) -> PartitionSpec:
    """Spec of a client-stacked ``[K, ...]`` array: rows over the client
    axes when divisible (``client_axes``), replicated otherwise."""
    axes = client_axes(mesh, int(shape[0]))
    return P(axes, *([None] * (len(shape) - 1)))


def client_stack_sharding(mesh, shape: Sequence[int]):
    """DTensor placements of a client-stacked ``[K, ...]`` array on
    ``mesh`` (``client_stack_spec``)."""
    return to_placements(mesh, client_stack_spec(mesh, shape))


# parameter-name -> trailing-dims spec ('DP' = fsdp data axes, 'MP' = model)
_PARAM_RULES: Dict[str, Tuple] = {
    # attention projections [D, N, hd] / [N, hd, D]
    "wq": ("DP", "MP", None), "wk": ("DP", "MP", None),
    "wv": ("DP", "MP", None), "w_o": ("DP", "MP", None),
    "wo3": ("MP", None, "DP"),           # attn out  [N, hd, D]
    # dense mlp [D, F] / [F, D]
    "wi2": ("DP", "MP"), "wg2": ("DP", "MP"), "wo2": ("MP", "DP"),
    # moe [E, D, F] / [E, F, D]: expert-parallel preferred, TP fallback
    "wi3": ("MP", "DP", None), "wg3": ("MP", "DP", None),
    "woe": ("MP", None, "DP"),
    "router": (None, None),
    # embeddings [V, D]
    "table": ("MP", "DP"),
    # rg-lru
    "w_in": ("DP", "MP"), "w_gate_x": ("DP", "MP"),
    "w_rec_gate": ("MP", None), "w_in_gate": ("MP", None),
    "lambda": ("MP",), "w_out": ("MP", "DP"),
    # slstm
    "w_z": ("DP", "MP"), "w_i": ("DP", "MP"), "w_f": ("DP", "MP"),
    # mlstm gates [D, N, 2]
    "w_if": ("DP", None, None),
    # generic dense (whisper biases / gan fc)
    "w": ("DP", "MP"), "b": (None,),
    # norms / bn
    "scale": (None,), "bias": (None,), "mean": (None,), "var": (None,),
    # conv kernels (gan): replicated
    "convw": (None, None, None, None),
}

# the port's conv kernels are OIHW and its transposed-conv kernels (I, O,
# kh, kw) where the reference keeps HWIO (``repro_torch.bridge``): the
# reference-layout dim each of the four trailing port dims holds
_CONV_FROM_HWIO = {"conv": (3, 2, 0, 1), "convt": (2, 3, 0, 1)}


def param_spec(mesh, policy: ShardingPolicy, path: str,
               shape: Sequence[int]) -> PartitionSpec:
    """path: '/'-joined key path; shape: full leaf shape (may include
    leading scan-layer and/or client axes, padded with None). A GAN conv
    kernel gets the spec the reference gives the same kernel, its
    entries moved to the port's layout."""
    keys = path.split("/")
    kind = keys[-2] if len(keys) >= 2 and keys[-1] == "w" else None
    if kind in _CONV_FROM_HWIO and len(shape) >= 4:
        lead, perm = len(shape) - 4, _CONV_FROM_HWIO[kind]
        hwio = list(shape[:lead]) + [0] * 4
        for i, src in enumerate(perm):
            hwio[lead + src] = shape[lead + i]
        spec = _param_spec(mesh, policy, path, hwio)
        if len(spec) != len(shape):
            return spec
        return P(*spec[:lead], *(spec[lead + src] for src in perm))
    return _param_spec(mesh, policy, path, shape)


def _param_spec(mesh, policy: ShardingPolicy, path: str,
                shape: Sequence[int]) -> PartitionSpec:
    name = path.split("/")[-1]
    ndim = len(shape)
    names = axis_names(mesh)
    # moe weights are [E, D, F]/[E, F, D]; attn wo is [N, hd, D]; dense
    # mlp wi/wo are rank 2: the path tells them apart
    model_size = axis_sizes(mesh).get("model", 1)
    if name in ("wi", "wg", "wo") and "moe" in path:
        n_experts = shape[-3]
        ep = n_experts % model_size == 0   # expert-parallel feasible?
        if name in ("wi", "wg"):           # [E, D, F]
            rule = ("MP", "DP", None) if ep else (None, "DP", "MP")
        else:                              # wo [E, F, D]
            rule = ("MP", None, "DP") if ep else (None, "MP", "DP")
    elif name in ("wi", "wg"):
        rule = _PARAM_RULES["wi2"]
    elif name == "wo" and "attn" in path:
        rule = _PARAM_RULES["wo3"]
    elif name == "wo":
        rule = _PARAM_RULES["wo2"]
    else:
        rule = _PARAM_RULES.get(name)
    if rule is None:
        return P()
    rule = tuple(rule)
    # pad leading dims (scan layer axis, stacked client axis) with None
    if len(rule) > ndim:
        return P()
    full = (None,) * (ndim - len(rule)) + rule
    dp = data_axes(mesh) if policy.fsdp else ()
    resolved = []
    for ax in full:
        if ax == "DP":
            resolved.append((dp if len(dp) != 1 else dp[0]) if dp else None)
        elif ax == "MP":
            resolved.append("model" if "model" in names else None)
        else:
            resolved.append(ax)
    return sanitize(mesh, shape, resolved)


def _walk(tree, path: Tuple[str, ...] = ()):
    """(path, leaf) pairs as ``jax.tree_util`` orders and names them:
    dict keys sorted, sequence indices, NamedTuple fields as '.name'."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _walk(getattr(tree, f), path + (f".{f}",))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, path + (str(i),))
    elif tree is not None:
        yield path, tree


def _rebuild(tree, leaves, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, path + (str(k),)) for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_rebuild(getattr(tree, f), leaves,
                                     path + (f".{f}",))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaves, path + (str(i),))
                          for i, v in enumerate(tree))
    return None if tree is None else leaves[path]


def tree_param_specs(mesh, policy: ShardingPolicy, params) -> Any:
    """A ``PartitionSpec`` tree matching ``params`` (dicts, lists,
    tuples and NamedTuples of tensors or arrays)."""
    specs = {path: param_spec(mesh, policy, "/".join(path),
                              tuple(np.shape(leaf)))
             for path, leaf in _walk(params)}
    return _rebuild(params, specs)


def tree_shardings(mesh, policy: ShardingPolicy, params) -> Any:
    """DTensor placements per leaf (``to_placements`` of each spec)."""
    return _rebuild(params, {
        path: to_placements(mesh, param_spec(mesh, policy, "/".join(path),
                                             tuple(np.shape(leaf))))
        for path, leaf in _walk(params)})


def to_placements(mesh, spec: Sequence) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``, one per mesh dim:
    ``Shard(d)`` on every mesh dim whose axis name tensor dim d's entry
    holds (a dim over several axes shards on each of them, major
    first), ``Replicate()`` on the rest."""
    from torch.distributed.tensor import Replicate, Shard
    dim_of: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for ax in ((entry,) if isinstance(entry, str) else tuple(entry)):
            dim_of[ax] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in axis_names(mesh))


# ---------------------------------------------------------------------------
# activation specs (``maybe_shard`` inside the model)
# ---------------------------------------------------------------------------

def act_spec(mesh, policy: ShardingPolicy, kind: str) -> PartitionSpec:
    dp = data_axes(mesh)
    dpa = dp if len(dp) != 1 else dp[0]
    mp = "model" if "model" in axis_names(mesh) else None
    if kind == "resid":     # [B, S, D] between blocks
        return P(dpa, mp if policy.seq_parallel else None, None)
    if kind == "resid_inner":
        # [B, S, D] entering attention/ffn: seq gathered, D replicated
        # within the model group (Megatron column/row-parallel semantics)
        return P(dpa, None, None)
    if kind == "tokens":    # [B, S]
        return P(dpa, None)
    if kind == "cache":     # [B, S, KV, hd]
        return P(dpa, mp if policy.shard_cache_seq else None, None, None)
    if kind == "state":     # [B, R...]
        return P(dpa)
    if kind == "logits":    # [B, S, V]
        return P(dpa, None, mp)
    if kind == "rows":      # [N_rows, ...] population-batch tensors
        return P(dpa)
    return P()


_MESH_STACK: list = []


class activation_sharding:
    """Context manager installing (mesh, policy) for ``maybe_shard``."""

    def __init__(self, mesh, policy: Optional[ShardingPolicy]):
        self.pair = (mesh, policy or ShardingPolicy())

    def __enter__(self):
        _MESH_STACK.append(self.pair)
        return self

    def __exit__(self, *exc):
        _MESH_STACK.pop()
        return False


def active_mesh():
    """The innermost ``activation_sharding``'s (mesh, policy), or
    (None, None) outside every one."""
    if not _MESH_STACK:
        return None, None
    return _MESH_STACK[-1]


def maybe_shard(x, kind: str):
    """Lay ``x`` out as ``act_spec(kind)`` says under the innermost
    ``activation_sharding``: a DTensor is redistributed to the spec's
    placements; a plain tensor (each rank holding its own) is returned
    as it is, as is anything outside a context or under mesh None."""
    mesh, policy = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = act_spec(mesh, policy, kind)
    spec = sanitize(mesh, x.shape,
                    tuple(spec) + (None,) * (x.ndim - len(spec)))
    return x.redistribute(x.device_mesh, to_placements(x.device_mesh, spec))

