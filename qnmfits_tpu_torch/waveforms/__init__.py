"""Waveform containers (port of qnmfits_tpu/waveforms): ``Custom`` (any
mode dictionary), ``SXS`` (the `sxs` package or a local SXS-format
cache; nothing is downloaded) and the surrogates ``NRSur7dq4`` and
``NRHybSur3dq8`` (they need `gwsurrogate` and `surfinBH`).  Host NumPy
and scipy; the fits take their ``times``, ``h``, ``Mf``, ``chif_mag``
and the ``Moft`` / ``chioft_mag`` tracks."""

from .base import BaseWaveform  # noqa: F401
from .custom import Custom  # noqa: F401
from .sxs import SXS  # noqa: F401
from .surrogate import NRHybSur3dq8, NRSur7dq4  # noqa: F401
