"""The port's host API around the fits against the JAX package's: the
plotting functions' content on the Agg backend, ``utils`` (timed,
debug_nans, sweep_progress, resumable_sweep), ``download_cook_data``,
``qnm.multiplet_list``, the module-level ``qnm`` and the lazy waveform
attributes."""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

import qnmfits_tpu as qf  # noqa: E402
import qnmfits_tpu_torch as qt  # noqa: E402
from qnmfits_tpu import plotting as pj  # noqa: E402
from qnmfits_tpu.utils import checkpoint as ckpt_j  # noqa: E402
from qnmfits_tpu_torch import plotting as pt  # noqa: E402
from qnmfits_tpu_torch.ops import chol_cuda  # noqa: E402
from qnmfits_tpu_torch.testing import synthetic_multimode  # noqa: E402
from qnmfits_tpu_torch.utils import (debug_nans, resumable_sweep,  # noqa
                                     sweep_progress, timed)

MODES = [(2, 2, n, 1) for n in range(3)]
MF, CHIF = 0.952, 0.692


@pytest.fixture(scope="module")
def syn():
    times = np.arange(-10.0, 60.0, 0.1)
    return synthetic_multimode(modes=MODES, spherical_modes=[(2, 2), (3, 2)],
                               Mf=MF, chif=CHIF, times=times, seed=12)


@pytest.fixture(scope="module")
def fits(syn):
    """The port's single and multimode fits at t0 = 5 (NumPy result
    dicts) and its amplitude_stability result, on the CPU."""
    times, data = syn["times"], syn["data_dict"]
    single = qt.ringdown_fit(times, data[(2, 2)], MODES, MF, CHIF, 5.0,
                             T=40, device="cpu")
    multi = qt.multimode_ringdown_fit(times, data, MODES, MF, CHIF, 5.0,
                                      T=40, device="cpu")
    stab = qt.amplitude_stability(times, data[(2, 2)], MODES, MF, CHIF,
                                  np.linspace(0.0, 20.0, 21), T_array=40,
                                  device="cpu")
    return single, multi, stab


def _content(ax):
    """What an axes shows: its lines' data, images, labels, scales,
    limits, legend and tick labels."""
    fig = ax.figure
    out = dict(
        lines=[(np.asarray(l.get_xdata(), float), np.asarray(l.get_ydata(),
                                                             float))
               for l in ax.lines],
        images=[np.asarray(im.get_array()) for a in fig.axes
                for im in a.images],
        extents=[im.get_extent() for a in fig.axes for im in a.images],
        labels=(ax.get_xlabel(), ax.get_ylabel()),
        scales=(ax.get_xscale(), ax.get_yscale()),
        limits=(ax.get_xlim(), ax.get_ylim()),
        ticks=[t.get_text() for t in ax.get_xticklabels()],
        legend=None if ax.get_legend() is None
        else [t.get_text() for t in ax.get_legend().get_texts()])
    plt.close(fig)
    return out


def _same_content(a, b):
    assert len(a["lines"]) == len(b["lines"]) > 0 or a["images"]
    for (xa, ya), (xb, yb) in zip(a["lines"], b["lines"]):
        np.testing.assert_array_equal(xa, xb)
        np.testing.assert_array_equal(ya, yb)
    assert len(a["images"]) == len(b["images"])
    for ia, ib in zip(a["images"], b["images"]):
        np.testing.assert_array_equal(ia, ib)
    for key in ("extents", "labels", "scales", "limits", "ticks", "legend"):
        assert a[key] == b[key], key


@pytest.mark.parametrize("log", [False, True])
def test_plot_ringdown_matches_jax(syn, fits, log, tmp_path):
    single, multi, _ = fits
    times, data = syn["times"], syn["data_dict"]
    for fit, kw in ((single, {}), (multi, dict(spherical_mode=(3, 2)))):
        d = data if kw else data[(2, 2)]
        out = tmp_path / "ringdown.png"
        a = _content(pt.plot_ringdown(times, d, best_fit=fit, log=log,
                                      outfile=str(out), **kw))
        assert out.exists() and os.path.getsize(out) > 0
        _same_content(a, _content(pj.plot_ringdown(times, d, best_fit=fit,
                                                   log=log, **kw)))
        np.testing.assert_array_equal(
            a["lines"][1][1], (np.abs if log else np.asarray)(np.real(
                fit["model"][(3, 2)] if kw else fit["model"])))
    with pytest.raises(ValueError, match="spherical_mode"):
        pt.plot_ringdown(times, data)


@pytest.mark.parametrize("plot_type", ["re", "im"])
def test_plot_ringdown_modes_matches_jax(fits, plot_type):
    single = fits[0]
    a = _content(pt.plot_ringdown_modes(single, plot_type=plot_type,
                                        xlim=(5, 30), ylim=(-1, 1)))
    _same_content(a, _content(pj.plot_ringdown_modes(
        single, plot_type=plot_type, xlim=(5, 30), ylim=(-1, 1))))
    assert len(a["lines"]) == len(MODES) + 1
    assert a["legend"] == single["mode_labels"] + ["Sum"]


@pytest.mark.parametrize("n_modes", [3, 30])
def test_plot_mode_amplitudes_matches_jax(fits, n_modes):
    C = np.resize(fits[0]["C"], n_modes)
    labels = [f"m{i}" for i in range(n_modes)]
    for log in (False, True):
        a = _content(pt.plot_mode_amplitudes(C, labels, log=log))
        _same_content(a, _content(pj.plot_mode_amplitudes(C, labels,
                                                          log=log)))
        assert a["ticks"] == labels


def test_plot_grids_match_jax(syn):
    times, data = syn["times"], syn["data_dict"]
    box = ((0.9, 1.0), (0.6, 0.78))
    mm = qt.mismatch_M_chi_grid(times, data[(2, 2)], MODES, *box, 5.0, T=40,
                                res=6, device="cpu")
    for truth in ((MF, CHIF), (1.5, CHIF), None):
        kw = dict(truth=truth, marker=(0.95, 0.7))
        a = _content(pt.plot_mismatch_M_chi_grid(mm, *box, **kw))
        _same_content(a, _content(pj.plot_mismatch_M_chi_grid(mm, *box,
                                                                 **kw)))
        np.testing.assert_array_equal(a["images"][0], np.log10(mm))
    wbox = ((0.3, 0.7), (-0.3, -0.01))
    mo = qt.mismatch_omega_grid(times, data[(2, 2)], MODES[:1], MF, CHIF,
                                *wbox, 5.0, T=40, res=6, device="cpu")
    a = _content(pt.plot_mismatch_omega_grid(mo, *wbox, truth=(-0.1, 0.5)))
    _same_content(a, _content(pj.plot_mismatch_omega_grid(
        mo, *wbox, truth=(-0.1, 0.5))))


def test_plot_amplitude_stability_matches_jax(fits):
    stab = fits[2]
    truth = np.ones(len(MODES))
    a = _content(pt.plot_amplitude_stability(stab, truth=truth,
                                             xlim=(0, 20)))
    _same_content(a, _content(pj.plot_amplitude_stability(
        stab, truth=truth, xlim=(0, 20))))
    np.testing.assert_array_equal(a["lines"][0][1], np.abs(stab["A"][:, 0]))


# -- utils -------------------------------------------------------------------

def _ls(path):
    return sorted(os.listdir(path))


def test_resumable_sweep_resumes_as_jax(tmp_path):
    items = np.linspace(0.0, 1.0, 10)
    calls = []

    def fn(block):
        calls.append(len(block))
        return block ** 2, torch.as_tensor(block * 3.0)

    out = resumable_sweep(fn, items, str(tmp_path / "t"), block=4)
    assert calls == [4, 4, 2] and isinstance(out, tuple)
    ref = ckpt_j.resumable_sweep(lambda b: (b ** 2, b * 3.0), items,
                                 str(tmp_path / "j"), block=4)
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(o, r)
    assert _ls(tmp_path / "t") == _ls(tmp_path / "j")
    calls.clear()
    os.remove(tmp_path / "t" / "block_00001.npz")
    again = resumable_sweep(fn, items, str(tmp_path / "t"), block=4)
    assert calls == [4]
    for o, r in zip(again, out):
        np.testing.assert_array_equal(o, r)


def test_resumable_sweep_guards(tmp_path):
    items = np.arange(6.0)
    path = str(tmp_path / "g")
    bare = resumable_sweep(lambda b: b + 1.0, items, path, block=4)
    assert isinstance(bare, np.ndarray)
    one = resumable_sweep(lambda b: (b + 1.0,), items, str(tmp_path / "o"),
                          block=4)
    assert isinstance(one, tuple) and len(one) == 1
    for other, block in ((items + 1.0, 4), (items, 3)):
        with pytest.raises(ValueError, match="different sweep"):
            resumable_sweep(lambda b: b, other, path, block=block)
    with pytest.raises(ValueError, match="first axis"):
        resumable_sweep(lambda b: b[:1], items, str(tmp_path / "s"), block=4)
    with pytest.raises(ValueError, match="empty"):
        resumable_sweep(lambda b: b, items[:0], str(tmp_path / "e"))
    os.remove(os.path.join(path, "meta.npz"))
    np.savez(os.path.join(path, "meta.npz"), items=items, block=4)
    with pytest.raises(ValueError, match="out of band"):
        resumable_sweep(lambda b: b + 1.0, items, path, block=4)


def test_resumable_sweep_takes_port_sweeps(syn, tmp_path):
    times, row = syn["times"], syn["data_dict"][(2, 2)]
    t0s = np.linspace(0.0, 20.0, 24)

    def fn(block):
        return qt.mismatch_t0_array(times, row, MODES, MF, CHIF, block,
                                    T_array=40, device="cpu")

    out = resumable_sweep(fn, t0s, str(tmp_path / "p"), block=10)
    np.testing.assert_allclose(out, fn(t0s), rtol=0, atol=1e-15)
    assert resumable_sweep(fn, t0s, str(tmp_path / "p"), block=10).shape \
        == (24,)


def test_timed_synchronises_initialised_devices(monkeypatch):
    said, synced = [], []
    with timed("cpu block", printer=said.append):
        torch.ones(3).sum()
    assert said[0].startswith("[cpu block] ") and said[0].endswith("s")
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)
    with timed(printer=said.append):
        pass
    assert synced == [0, 1] and said[1].startswith("[timed] ")


def test_debug_nans_raises_on_a_port_fit(syn):
    times = syn["times"]
    row = syn["data_dict"][(2, 2)].copy()
    row[len(row) // 2] = np.nan
    out = qt.ringdown_fit(times, row, MODES, MF, CHIF, 0.0, device="cpu")
    assert np.isnan(out["mismatch"])          # outside the scope: no check
    assert not chol_cuda.check_nans
    with debug_nans():
        assert chol_cuda.check_nans
        with pytest.raises(FloatingPointError, match="NaN"):
            qt.ringdown_fit(times, row, MODES, MF, CHIF, 0.0, device="cpu")
        with pytest.raises(FloatingPointError, match="NaN"):
            qt.mismatch_t0_array(times, row, MODES, MF, CHIF,
                                 np.array([0.0, 1.0]), device="cpu")
        with debug_nans(False):
            assert not chol_cuda.check_nans
            qt.ringdown_fit(times, row, MODES, MF, CHIF, 0.0, device="cpu")
        assert chol_cuda.check_nans
        clean = qt.ringdown_fit(times, syn["data_dict"][(2, 2)], MODES, MF,
                                CHIF, 0.0, device="cpu")
        assert np.isfinite(clean["mismatch"])
    assert not chol_cuda.check_nans
    assert torch._C._len_torch_function_stack() == 0


def test_sweep_progress(monkeypatch):
    wrapped = sweep_progress(range(3), desc="blocks")
    assert type(wrapped).__name__ == "tqdm" and list(wrapped) == [0, 1, 2]
    assert sweep_progress([1, 2], use_tqdm=False) == [1, 2]
    monkeypatch.setitem(sys.modules, "tqdm", None)
    assert sweep_progress([1, 2]) == [1, 2]


# -- the package's surface -----------------------------------------------

def test_download_cook_data_and_multiplets(capsys):
    qt.download_cook_data()
    said = capsys.readouterr().out
    assert "qnmfits_tpu_torch" in said and "nothing to download" in said
    assert qt.qnm.multiplet_list == qf.qnm.multiplet_list


def test_module_level_qnm_and_lazy_attributes():
    from qnmfits_tpu_torch import qnm_api, waveforms
    assert qt.qnm is qnm_api.get_qnm() and qt.qnm is qt.qnm
    assert qt.qnm.omega(2, 2, 0, 1, CHIF, MF) == qf.qnm.omega(2, 2, 0, 1,
                                                               CHIF, MF)
    for name in ("Custom", "SXS", "NRSur7dq4", "NRHybSur3dq8"):
        assert getattr(qt, name) is getattr(waveforms, name)
        assert name in qt.__all__
    for name in pt.__all__:
        assert getattr(qt, name) is getattr(pt, name)
    assert qt.utils.resumable_sweep is resumable_sweep
    with pytest.raises(AttributeError, match="no attribute"):
        qt.not_a_thing
