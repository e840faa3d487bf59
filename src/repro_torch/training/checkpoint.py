"""Checkpoints in the reference's flat ``.npz`` format, written and read
with numpy alone (the reference ``repro.training.checkpoint``).

A tree of dicts, lists and tuples is flattened into ``/``-joined path
keys; each list or tuple adds ``<path>/__len__`` and ``<path>/__tuple__``
markers so that it comes back as what it was; a bfloat16 leaf is stored
as its uint16 bit pattern under ``<path>::bf16``. ``save`` writes
atomically (a temporary file in the same directory, then a rename), so a
reader never sees half a file. A file written here restores in the
reference's ``restore``, and one written there loads here, with
``load_npz`` or under the reference's name, ``restore``.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch


def _flatten(tree, prefix: str = "") -> dict:
    """Flatten a dict/list/tuple tree into path-keyed leaves."""
    out = {}
    if isinstance(tree, dict):
        for key, val in tree.items():
            out.update(_flatten(val, f"{prefix}{key}/"))
    elif isinstance(tree, (list, tuple)):
        for i, val in enumerate(tree):
            out.update(_flatten(val, f"{prefix}{i}/"))
        out[f"{prefix}__len__"] = np.asarray(len(tree))
        out[f"{prefix}__tuple__"] = np.asarray(isinstance(tree, tuple))
    else:
        out[prefix.rstrip("/")] = tree
    return out


def _to_numpy(leaf) -> tuple[np.ndarray, bool]:
    """(host array, is bfloat16); a bfloat16 leaf as its uint16 bits."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), True
        return t.numpy(), False
    return np.asarray(leaf), False


def save(path: str, tree) -> None:
    """Write a tree of torch tensors or numpy arrays to ``path`` as a flat
    ``.npz``, atomically (temporary file + rename)."""
    flat = {}
    for key, leaf in _flatten(tree).items():
        arr, bf16 = _to_numpy(leaf)
        flat[key + "::bf16" if bf16 else key] = arr
    folder = os.path.dirname(path) or "."
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **flat)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_npz(path) -> dict:
    """Read a checkpoint in the reference's flat ``.npz`` layout.

    Keys are ``/``-joined paths; ``__len__``/``__tuple__`` markers rebuild
    lists and tuples; bfloat16 leaves are stored as uint16 views under a
    ``::bf16`` suffix and come back as ``torch.bfloat16`` tensors. Other
    leaves come back as torch tensors too. Uses numpy alone.
    """
    with np.load(path) as z:
        flat = {}
        for key in z.files:
            if key.endswith("::bf16"):
                flat[key[:-6]] = torch.from_numpy(
                    z[key].astype(np.uint16)).view(torch.bfloat16)
            else:
                flat[key] = torch.from_numpy(np.array(z[key]))
    root: dict = {}
    meta: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        if parts[-1] in ("__len__", "__tuple__"):
            meta["/".join(parts[:-1]) + "/" + parts[-1]] = val
            continue
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = val

    def fix(node, prefix=""):
        if not isinstance(node, dict):
            return node
        n_key = f"{prefix}__len__"
        if n_key in meta:
            seq = [fix(node[str(i)], f"{prefix}{i}/")
                   for i in range(int(meta[n_key]))]
            return tuple(seq) if bool(meta[f"{prefix}__tuple__"]) else seq
        return {k: fix(v, f"{prefix}{k}/") for k, v in node.items()}

    return fix(root)


#: the reference's name for ``load_npz``
restore = load_npz
