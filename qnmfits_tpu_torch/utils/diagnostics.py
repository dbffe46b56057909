"""Lightweight observability: timing, progress, NaN checking (port of
qnmfits_tpu/utils/diagnostics.py).

The reference's only observability is tqdm progress bars on its serial
grid loops (qnmfits.py:1391, 1402, 1757) and print-based error reporting.
The equivalents here: a timing context that waits for the card, a
progress wrapper for host-chunked sweeps, and a NaN-checking scope, the
counterpart of JAX's ``jax_debug_nans``.
"""

from __future__ import annotations

import contextlib
import time

import torch
from torch.overrides import TorchFunctionMode

from ..ops import chol_cuda

__all__ = ["timed", "debug_nans", "sweep_progress"]


@contextlib.contextmanager
def timed(label: str = "", printer=print):
    """Wall-time a block.  CUDA work is queued asynchronously, so on exit
    every CUDA device this process has initialised is synchronised before
    the clock is read; on the CPU nothing more is done."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if torch.cuda.is_initialized():
            for dev in range(torch.cuda.device_count()):
                torch.cuda.synchronize(dev)
        printer(f"[{label or 'timed'}] {time.perf_counter() - t0:.3f}s")


def _name(func):
    return getattr(func, "__qualname__", None) or getattr(
        func, "__name__", repr(func))


class _NanCheck(TorchFunctionMode):
    """Raises FloatingPointError when a torch function returns a floating
    or complex tensor that holds NaN, while ``chol_cuda.check_nans`` is
    on (a nested ``debug_nans(False)`` turns it off)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not chol_cuda.check_nans:
            return out
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if (isinstance(t, torch.Tensor)
                    and (t.is_floating_point() or t.is_complex())
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of "
                                         f"{_name(func)}")
        return out


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Within the scope, a NaN that a torch operation of the port produces
    raises FloatingPointError (the counterpart of toggling
    ``jax_debug_nans``).  Each operation's output is checked through a
    torch function mode, and the CUDA solve's output by its wrapper
    (``ops.chol_cuda.check_nans``), which no mode sees.  Host NumPy is not
    checked.  ``enable=False`` turns the checks off within the scope;
    outside every enabled scope nothing is checked and nothing costs."""
    prev = chol_cuda.check_nans
    chol_cuda.check_nans = bool(enable)
    try:
        if enable:
            with _NanCheck():
                yield
        else:
            yield
    finally:
        chol_cuda.check_nans = prev


def sweep_progress(items, desc: str = "", use_tqdm: bool = True):
    """Progress iterator for host-level chunk loops (falls back to a
    plain iterator when tqdm is unavailable or disabled)."""
    if use_tqdm:
        try:
            from tqdm import tqdm
            return tqdm(items, desc=desc)
        except ImportError:
            pass
    return items
