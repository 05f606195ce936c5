"""Checkpoints: per-task parameter trees and the task chain, as .npz files.

Counterpart of ``vargp_tpu/utils/checkpoint.py``, in numpy alone, and
readable both ways: a chain that either package writes loads in the
other.  Leaves are keyed by the JAX package's key paths (``.z``,
``.u_mean``, ``.u_tril_vec``, ``.kernel.log_mean``, ``.kernel.log_logvar``
and, under the deep kernel, ``.phi.weights[i]``, ``.phi.biases[i]``), and
a ``.structure.json`` beside each file records the tree's structure, the
leaf count and every leaf's shape and dtype.  The round-1 format, keys
``leaf_{i}`` in tree order, is read with a count check.  The JAX
package's orbax backend is JAX-only and has no counterpart here.

A tree is NamedTuples, tuples and None over leaves; tensors are written
through ``.detach().cpu()`` and loads return numpy leaves in the
template's structure (``utils.convert.params_from_numpy`` puts them on a
device).
"""

import json
import os

import numpy as np

from vargp_tpu_torch.train.optim import tree_unflatten


class CheckpointStructureError(RuntimeError):
    """The checkpoint on disk does not match the template tree, e.g. a
    resume with another configuration (M, dkl, out_size)."""


def _numpy(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):  # a torch.Tensor
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def flatten_with_paths(tree, path: str = "") -> list:
    """[(key path, leaf)] in the JAX package's flattening order, the paths
    as ``jax.tree_util.keystr`` writes them (``.kernel.log_mean``,
    ``.phi.weights[0]``)."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        if hasattr(tree, "_fields"):
            keys = [f".{f}" for f in tree._fields]
        else:
            keys = [f"[{i}]" for i in range(len(tree))]
        return [kv for k, sub in zip(keys, tree) for kv in flatten_with_paths(sub, path + k)]
    return [(path, tree)]


def _treedef(tree) -> str:
    """The tree's structure as ``str(jax.tree_util.tree_structure(tree))``
    prints it."""
    def node(t):
        if t is None:
            return "None"
        if isinstance(t, tuple):
            kids = ", ".join(node(s) for s in t)
            if hasattr(t, "_fields"):
                return f"CustomNode(namedtuple[{type(t).__name__}], [{kids}])"
            return f"({kids},)" if len(t) == 1 else f"({kids})"
        return "*"

    return f"PyTreeDef({node(tree)})"


def save_pytree(path: str, tree) -> None:
    """Save a tree's leaves to ``path`` (.npz, keyed by key path) and its
    structure to ``path + ".structure.json"``."""
    arrays = {k: _numpy(v) for k, v in flatten_with_paths(tree)}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, **arrays)
    with open(path + ".structure.json", "w") as f:
        json.dump(
            {
                "treedef": _treedef(tree),
                "n_leaves": len(arrays),
                "leaves": {
                    k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                    for k, v in arrays.items()
                },
            },
            f,
        )


def load_pytree(path: str, like):
    """The arrays saved at ``path`` in the structure of ``like``, checked
    leaf by leaf: a missing or extra key, or a shape unlike the template's,
    raises ``CheckpointStructureError`` naming the file and the leaf."""
    flat = flatten_with_paths(like)
    want = dict(flat)
    with np.load(path) as data:
        stored = {k: data[k] for k in data.files}

    if stored and all(k.startswith("leaf_") for k in stored):
        # the round-1 format, keyed by tree order: count-checked
        if len(stored) != len(want):
            raise CheckpointStructureError(
                f"{path}: legacy checkpoint has {len(stored)} leaves but the "
                f"template expects {len(want)}: was it written with another "
                f"model configuration?"
            )
        return tree_unflatten(like, [stored[f"leaf_{i}"] for i in range(len(stored))])
    missing = sorted(set(want) - set(stored))
    extra = sorted(set(stored) - set(want))
    if missing or extra:
        raise CheckpointStructureError(
            f"{path}: checkpoint structure mismatch: missing leaves {missing[:4]}"
            f"{'...' if len(missing) > 4 else ''}, unexpected leaves {extra[:4]}"
            f"{'...' if len(extra) > 4 else ''}. Check that the configuration "
            f"(M, out_size, dkl) matches the saved run."
        )
    leaves = []
    for k, template_leaf in flat:
        arr = stored[k]
        tshape = tuple(getattr(template_leaf, "shape", ()))
        if tuple(arr.shape) != tshape:
            raise CheckpointStructureError(
                f"{path}: leaf {k!r} has shape {tuple(arr.shape)} but the template "
                f"expects {tshape}: a configuration mismatch (M, out_size, in_size?)"
            )
        leaves.append(arr)
    return tree_unflatten(like, leaves)


def save_chain(log_dir: str, task_id: int, params) -> str:
    """Save task ``task_id``'s parameters as ``ckpt{task_id}.npz``."""
    path = os.path.join(log_dir, f"ckpt{task_id}.npz")
    save_pytree(path, params)
    return path


def load_chain(log_dir: str, n_tasks: int, like):
    """Load ``ckpt0`` .. ``ckpt{n_tasks - 1}``; ``like`` is one template tree
    for every task or a list of one per task.  (The JAX package also takes
    a tuple for a list, and so reads a single NamedTuple template as one
    template per field; here a tuple is always one tree.)"""
    return [
        load_pytree(os.path.join(log_dir, f"ckpt{t}.npz"),
                    like[t] if isinstance(like, list) else like)
        for t in range(n_tasks)
    ]
