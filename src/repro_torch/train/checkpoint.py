"""Checkpointing: atomic, async, restored in place.

The counterpart of ``repro/train/checkpoint.py``. Layout:

    <dir>/step_<N>/
        manifest.json      leaf paths, shapes, dtypes, step, extras
        leaf_<i>.npy       one blob per tensor of the state

A state is a nest of dicts (in sorted-key order, as the reference
flattens them), lists, tuples, ``nn.Module``s (their named parameters)
and tensors; a leaf's path names it (``params.blocks.0.attn.wq``,
``opt.mu.embed.tokens``). The manifest lists those paths where the
reference stores its treedef.

Guarantees, the reference's:
  * **atomic**: written to ``step_<N>.tmp`` then ``os.replace``d, so a
    crash mid-save never corrupts the latest checkpoint (restore scans for
    the newest complete manifest);
  * **async**: ``save(..., blocking=False)`` copies every tensor to host
    memory first (the snapshot), then writes on a background thread, and
    the step loop goes on updating the state in place;
  * keep-last-k GC;
  * the ``.npy`` format: bf16 stored as ``uint16`` views (numpy has no
    bf16), so a leaf's file holds the reference's bytes for the same
    values.

``restore`` copies into the given state's tensors in place, so a
``Model``'s parameters keep their identity.

**On a mesh** (``shardings``, the state's ``NamedSharding``s from
``train.state_shardings``, keyed as the state is) the blobs are global, as
the reference's are: ``save`` assembles every leaf from the ranks' blocks
on the step's thread (a gather every rank takes part in), and the mesh's
first rank writes the same files a one-device save of the same global
state writes, on the background thread when asked. ``wait`` ends with a
barrier over the mesh, so every rank then sees the same checkpoints.
``restore(..., shardings=)`` copies each rank's block of every global blob
into its leaf, so a checkpoint moves between one card and any mesh.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn


def _leaves(tree, prefix: Tuple[str, ...] = ()
            ) -> List[Tuple[str, torch.Tensor]]:
    if isinstance(tree, torch.Tensor):
        return [(".".join(prefix), tree)]
    if isinstance(tree, nn.Module):
        return [(".".join(prefix + (name,)), p)
                for name, p in tree.named_parameters()]
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, (list, tuple)):
        items = list(enumerate(tree))
    else:
        raise TypeError(f"cannot checkpoint a {type(tree).__name__} at "
                        f"{'.'.join(prefix) or 'the root'}")
    out = []
    for key, sub in items:
        out.extend(_leaves(sub, prefix + (str(key),)))
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _sharding_paths(tree, prefix: Tuple[str, ...] = ()) -> Dict:
    """{leaf path: NamedSharding} of a ``state_shardings`` tree (dicts of
    ``NamedSharding``s), with the paths ``_leaves`` gives the state's
    leaves."""
    if not isinstance(tree, dict):
        return {".".join(prefix): tree}
    out = {}
    for key, sub in tree.items():
        out.update(_sharding_paths(sub, prefix + (str(key),)))
    return out


def _writes(mesh) -> bool:
    """Whether this rank writes: the mesh's first, or the only one."""
    return mesh is None or all(mesh.index(a) == 0 for a in mesh)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._mesh = None           # the last sharded save's MeshAxes

    # ------------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = True,
             extras: Optional[Dict] = None, shardings=None) -> None:
        """Snapshot ``state`` now and write it (in the background unless
        ``blocking``). ``shardings``: on a mesh, the state's layout; every
        rank calls ``save``."""
        self.wait()
        leaves = _leaves(state)
        if shardings is not None:
            by_path = _sharding_paths(shardings)
            self._mesh = next(iter(by_path.values())).mesh
            with torch.no_grad():
                leaves = [(path, by_path[path].whole(t.detach()))
                          for path, t in leaves]
            if not _writes(self._mesh):
                return
        # the snapshot: a host copy of every leaf, made before returning
        host = [(path, t.detach().to("cpu", copy=True))
                for path, t in leaves]
        del leaves
        if blocking:
            self._write(step, host, extras or {})
        else:
            self._thread = threading.Thread(
                target=self._write_guard, args=(step, host, extras or {}),
                daemon=True)
            self._thread.start()

    def _write_guard(self, step, host, extras):
        try:
            self._write(step, host, extras)
        except BaseException as e:   # surfaced on next wait()
            self._error = e

    def _write(self, step: int, host, extras: Dict) -> None:
        final = os.path.join(self.dir, f"step_{step:09d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {
            "step": step,
            "leaves": [{"path": path, "file": f"leaf_{i}.npy",
                        "shape": list(t.shape), "dtype": _dtype_name(t)}
                       for i, (path, t) in enumerate(host)],
            "extras": extras,
        }
        for i, (_path, t) in enumerate(host):
            np.save(os.path.join(tmp, f"leaf_{i}.npy"), _to_numpy(t),
                    allow_pickle=False)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._mesh is not None and len(self._mesh.names) and \
                self._mesh.size(self._mesh.names) > 1:
            import torch.distributed as dist
            dist.barrier(group=self._mesh.group(self._mesh.names))
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.dir, name, "manifest.json")):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    @torch.no_grad()
    def restore(self, state, step: Optional[int] = None,
                shardings=None) -> Tuple[Any, Dict]:
        """Copy checkpoint ``step`` (default: the latest) into ``state``'s
        tensors in place; returns (state, extras). Each leaf's path, shape
        and dtype must match the manifest's. ``shardings``: on a mesh, the
        state's layout; each leaf takes its rank's block of the blob."""
        by_path = _sharding_paths(shardings) if shardings is not None \
            else {}
        if by_path:
            self._mesh = next(iter(by_path.values())).mesh
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        leaves = _leaves(state)
        if len(leaves) != len(manifest["leaves"]):
            raise ValueError(f"tree mismatch: {len(leaves)} vs "
                             f"{len(manifest['leaves'])} leaves")
        for (name, t), meta in zip(leaves, manifest["leaves"]):
            src = _from_numpy(np.load(os.path.join(path, meta["file"])),
                              meta["dtype"])
            if name in by_path:
                src = src[by_path[name].block(tuple(src.shape))]
            if (name, tuple(src.shape), _dtype_name(t)) != \
                    (meta["path"], tuple(t.shape), meta["dtype"]):
                raise ValueError(
                    f"leaf {name} {tuple(t.shape)} {_dtype_name(t)} does not "
                    f"match the checkpoint's {meta['path']} "
                    f"{tuple(src.shape)} {meta['dtype']}")
            t.copy_(src)
        return state, manifest["extras"]

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[:-self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"),
                          ignore_errors=True)
