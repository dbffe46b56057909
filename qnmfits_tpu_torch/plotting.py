"""Plot helpers, API-compatible with the reference's plotting functions
(port of qnmfits_tpu/plotting.py; the reference's qnmfits.py:914-1180,
1597-1676, 1830-1902).

Host-side matplotlib, imported lazily so headless and pipeline use of the
package never touches a display backend.  They take the port's result
dicts, whose arrays are NumPy already, and ``amplitude_stability``'s
result.
"""

from __future__ import annotations

import numpy as np

from .ref_impl import ringdown

__all__ = [
    "plot_ringdown", "plot_ringdown_modes", "plot_mode_amplitudes",
    "plot_mismatch_M_chi_grid", "plot_mismatch_omega_grid",
    "plot_amplitude_stability",
]


def _subplots(**kw):
    import matplotlib.pyplot as plt
    return plt.subplots(**kw)


def _finish(fig, outfile):
    import matplotlib.pyplot as plt
    if outfile is not None:
        plt.savefig(outfile)
        plt.close(fig)


def plot_ringdown(times, data, xlim=[-50, 100], best_fit=None,
                  spherical_mode=None, log=False, outfile=None, fig_kw={}):
    """Data with optional best-fit overlay (reference qnmfits.py:914-1010)."""
    if isinstance(data, dict):
        if spherical_mode is None:
            raise ValueError(
                "specify spherical_mode when plotting a mode dictionary")
        data = data[spherical_mode]
    data = np.abs(np.real(data)) if log else np.real(data)

    fig, ax = _subplots(figsize=(8, 4), **fig_kw)
    ax.plot(times, data, "k-", label="Re[data]")

    if best_fit is not None:
        model = best_fit["model"]
        if isinstance(model, dict):
            if spherical_mode is None:
                raise ValueError(
                    "specify spherical_mode for a multimode best fit")
            model = model[spherical_mode]
        model = np.abs(np.real(model)) if log else np.real(model)
        ax.plot(best_fit["model_times"], model, "r-", label="Re[model]",
                alpha=0.8)

    ax.set_xlim(*xlim)
    ax.set_xlabel(r"$t\ [M]$")
    if spherical_mode is None:
        ax.set_ylabel(r"$h$")
    else:
        ax.set_ylabel(
            rf"$h_{{{spherical_mode[0]}{spherical_mode[1]}}}$")
    if log:
        ax.set_yscale("log")
    ax.legend(frameon=False)
    _finish(fig, outfile)
    return ax


def plot_ringdown_modes(best_fit, spherical_mode=None, plot_type="re",
                        xlim=None, ylim=None, legend=True, outfile=None,
                        fig_kw={}):
    """Best-fit model decomposed into individual QNMs
    (reference qnmfits.py:1013-1120)."""
    fig, ax = _subplots(figsize=(8, 4), **fig_kw)

    if isinstance(best_fit["model"], dict):
        if spherical_mode is None:
            raise ValueError(
                "specify spherical_mode for a multimode best fit")
        mode_sum = np.zeros_like(best_fit["model"][spherical_mode])
        amplitudes = best_fit["weighted_C"][spherical_mode]
    else:
        mode_sum = np.zeros_like(best_fit["model"])
        amplitudes = best_fit["C"]

    part = np.real if plot_type == "re" else np.imag
    for i in range(len(best_fit["modes"])):
        wf = ringdown(best_fit["model_times"], best_fit["t0"],
                      [amplitudes[i]], [best_fit["frequencies"][i]])
        mode_sum = mode_sum + wf
        ax.plot(best_fit["model_times"], part(wf),
                alpha=0.5 if i > 9 else 0.7)
    ax.plot(best_fit["model_times"], part(mode_sum), "k--")

    if xlim is not None:
        ax.set_xlim(*xlim)
    if ylim is not None:
        ax.set_ylim(*ylim)
    ax.set_xlabel(r"$t\ [M]$")
    if spherical_mode is None:
        ax.set_ylabel(r"$h$")
    else:
        ax.set_ylabel(
            rf"$h_{{{spherical_mode[0]}{spherical_mode[1]}}}$")
    if legend:
        ax.legend(ax.lines, best_fit["mode_labels"] + ["Sum"], ncol=3)
    _finish(fig, outfile)
    return ax


def plot_mode_amplitudes(coefficients, labels, log=False, outfile=None,
                         fig_kw={}):
    """Stem plot of |C| per mode (reference qnmfits.py:1123-1180)."""
    amplitudes = np.abs(coefficients)
    x = np.arange(len(amplitudes))
    figsize = (len(x) * 0.3, 4) if len(x) > 24 else (6, 4)
    fig, ax = _subplots(figsize=figsize, **fig_kw)
    for i, a in enumerate(amplitudes):
        ax.plot([x[i], x[i]], [0, a], color=f"C{i}", marker="o",
                markevery=(1, 2), linestyle=":")
    if log:
        ax.set_yscale("log")
    ax.set_xticks(x)
    ax.set_xticklabels(labels)
    ax.tick_params(axis="x", rotation=90)
    ax.set_xlabel("Mode")
    ax.set_ylabel("$|C|$")
    _finish(fig, outfile)
    return ax


def _grid_heatmap(grid, extent, xlabel, ylabel, truth, marker,
                  truth_in_range, outfile, fig_kw):
    from mpl_toolkits.axes_grid1 import make_axes_locatable
    fig, ax = _subplots(**fig_kw)
    im = ax.imshow(np.log10(grid), extent=extent, aspect="auto",
                   origin="lower", interpolation="bicubic",
                   cmap="gist_heat_r")
    if truth is not None:
        h_ok, v_ok = truth_in_range
        if h_ok:
            ax.axhline(truth[0], color="w", alpha=0.3)
        if v_ok:
            ax.axvline(truth[1], color="w", alpha=0.3)
    if marker is not None:
        ax.plot(marker[0], marker[1], marker="o", markersize=3, color="k")
    divider = make_axes_locatable(ax)
    cax = divider.append_axes("right", size="5%", pad=0.05)
    cbar = fig.colorbar(im, cax=cax)
    cbar.ax.set_ylabel(r"$\mathrm{log}_{10}\ \mathcal{M}$")
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    import matplotlib.pyplot as plt
    plt.tight_layout()
    _finish(fig, outfile)
    return ax


def plot_mismatch_M_chi_grid(mm_grid, Mf_minmax, chif_minmax, truth=None,
                             marker=None, outfile=None, fig_kw={}):
    """log10 mismatch heatmap over (Mf, chif)
    (reference qnmfits.py:1597-1676)."""
    Mf_min, Mf_max = Mf_minmax
    chif_min, chif_max = chif_minmax
    truth_in = (True, True)
    if truth is not None:
        truth_in = (Mf_min <= truth[0] <= Mf_max,
                    chif_min <= truth[1] <= chif_max)
    mk = (marker[1], marker[0]) if marker is not None else None
    return _grid_heatmap(
        mm_grid, [chif_min, chif_max, Mf_min, Mf_max],
        r"$\chi_f$", r"$M_f\ [M]$", truth, mk, truth_in, outfile, fig_kw)


def plot_mismatch_omega_grid(mm_grid, re_minmax, im_minmax, truth=None,
                             marker=None, outfile=None, fig_kw={}):
    """log10 mismatch heatmap in the complex-frequency plane
    (reference qnmfits.py:1830-1902)."""
    return _grid_heatmap(
        mm_grid, [*re_minmax, *im_minmax],
        r"$\mathrm{Re}[\omega]$", r"$\mathrm{Im}[\omega]$",
        truth, marker, (True, True), outfile, fig_kw)


def plot_amplitude_stability(result, truth=None, xlim=None, ylim=None,
                             legend=True, outfile=None, fig_kw={}):
    """|A_j(t0)| per mode from `amplitude_stability`'s result dict
    (the Giesler+ arXiv:1903.08284 fig. 6 style stability plot; no
    reference counterpart).  truth, if given, is a (J,) array of known
    amplitudes drawn as horizontal dashed lines."""
    t0s = np.asarray(result["t0s"])
    absA = np.abs(np.asarray(result["A"]))
    fig, ax = _subplots(figsize=(8, 4), **fig_kw)
    for j, m in enumerate(result["modes"]):
        label = ",".join(str(int(x)) for x in m)
        ax.plot(t0s, absA[:, j], color=f"C{j % 10}",
                label=rf"$({label})$")
        if truth is not None:
            ax.axhline(np.abs(truth[j]), color=f"C{j % 10}",
                       linestyle="--", alpha=0.5)
    ax.set_yscale("log")
    if xlim is not None:
        ax.set_xlim(*xlim)
    if ylim is not None:
        ax.set_ylim(*ylim)
    ax.set_xlabel(r"$t_0\ [M]$")
    ax.set_ylabel(r"$|A|$ at $t_\mathrm{ref}$")
    if legend:
        ax.legend(frameon=False, ncol=3)
    _finish(fig, outfile)
    return ax
