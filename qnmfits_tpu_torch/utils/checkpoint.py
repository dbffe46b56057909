"""Chunk-level checkpointing for long sweeps (port of
qnmfits_tpu/utils/checkpoint.py).

The reference has no recovery story (its sweeps are single serial Python
loops, SURVEY.md section 5).  Here a long sweep is split into blocks,
each completed block's results are saved at once, and a re-run (after a
preemption, an out-of-memory error or a crash) resumes from the first
missing block.

Usage::

    import qnmfits_tpu_torch as qt
    from qnmfits_tpu_torch.utils import resumable_sweep

    mm = resumable_sweep(
        lambda t0_block: qt.mismatch_t0_array(
            times, data, modes, Mf, chif, t0_block, engine="fast"),
        t0_array, "sweep_ckpt", block=4096)

The checkpoint directory holds one ``block_#####.npz`` per completed
block plus ``meta.npz`` recording the item array and block size; a
resume against different items or block size raises instead of
silently mixing results.  A block's outputs may be NumPy arrays (what
the port's entry points return) or torch tensors on any device.
"""

from __future__ import annotations

import os

import numpy as np
import torch

__all__ = ["resumable_sweep"]


def _as_tuple(out):
    return out if isinstance(out, tuple) else (out,)


def _host(r):
    """A block output as a host NumPy array."""
    if isinstance(r, torch.Tensor):
        return r.detach().cpu().numpy()
    return np.asarray(r)


def resumable_sweep(fn_block, items, path, block: int = 4096,
                    progress: bool = False):
    """Run ``fn_block(items[a:b])`` over consecutive blocks of ``items``
    with per-block persistence to directory ``path``.

    fn_block must return an ndarray whose FIRST axis matches the block
    length, or a tuple of such arrays.  Returns the concatenated
    result(s) over all items (same structure as fn_block's output:
    a bare array stays bare, a tuple -- even a 1-tuple -- stays a
    tuple).  Completed blocks found in ``path`` are loaded instead of
    recomputed.
    """
    items = np.asarray(items)
    n = items.shape[0]
    if n == 0:
        raise ValueError("resumable_sweep: `items` is empty")
    n_blocks = -(-n // block)
    os.makedirs(path, exist_ok=True)

    def _save_atomic(fname, **arrays):
        # temp + rename so an interrupt never leaves a truncated file
        # (np.savez appends .npz to names without the extension).
        tmp = fname[:-4] + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, fname)

    meta_file = os.path.join(path, "meta.npz")
    bare = None                       # did fn_block return a bare array?
    if os.path.exists(meta_file):
        meta = np.load(meta_file)
        if int(meta["block"]) != block or not np.array_equal(
                meta["items"], items):
            raise ValueError(
                f"checkpoint at {path!r} was written for a different "
                f"sweep configuration (items/block changed); use a new "
                f"path or delete it")
        if "bare" in meta.files:
            bare = bool(meta["bare"])
    else:
        _save_atomic(meta_file, items=items, block=block)

    outs = []
    for bi in range(n_blocks):
        bfile = os.path.join(path, f"block_{bi:05d}.npz")
        if os.path.exists(bfile):
            z = np.load(bfile)
            outs.append(tuple(z[f"out{k}"] for k in range(len(z.files))))
            continue
        a, b = bi * block, min((bi + 1) * block, n)
        raw = fn_block(items[a:b])
        if bare is None:
            bare = not isinstance(raw, tuple)
            _save_atomic(meta_file, items=items, block=block, bare=bare)
        res = tuple(_host(r) for r in _as_tuple(raw))
        for r in res:
            if r.shape[0] != b - a:
                raise ValueError(
                    "fn_block must return arrays whose first axis "
                    f"matches the block length ({b - a}); got {r.shape}")
        _save_atomic(bfile, **{f"out{k}": r for k, r in enumerate(res)})
        outs.append(res)
        if progress:
            print(f"checkpoint: block {bi + 1}/{n_blocks} done",
                  flush=True)

    cat = tuple(np.concatenate([o[k] for o in outs], axis=0)
                for k in range(len(outs[0])))
    if bare is None:
        # meta always gains the flag before the first block file is
        # written, so this means meta.npz was recreated out of band
        # while block files survived -- refuse to guess the return
        # structure.
        raise ValueError(
            f"checkpoint at {path!r} has completed blocks but its meta "
            f"lacks the output-structure flag (meta.npz was recreated "
            f"out of band); delete the directory and re-run")
    return cat[0] if (bare and len(cat) == 1) else cat
