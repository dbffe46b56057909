"""``testing.run_world``'s ranks on gloo CPU ranks: a rank drops the
meshes ``parallel.mesh.sweep_mesh`` cached before its process group goes
(a cached DeviceMesh holds its gloo groups, and groups left to the
interpreter's teardown aborted a rank now and then with "terminate called
without an active exception"), and a rank that dies without a traceback
is reported with whether it wrote its result and the tail of its stderr.
"""

import gc
import os
import sys
import weakref

import pytest
import torch
import torch.distributed as dist

from qnmfits_tpu_torch.parallel import mesh
from qnmfits_tpu_torch.testing import run_world


def _sub_group_collectives(rounds):
    """The meshes of phase 13's N4 layout, (4, 1) and (2, 2), and an
    all-reduce over each of their groups, ``rounds`` times."""
    for _ in range(rounds):
        for shape in ((4, 1), (2, 2)):
            m = mesh.sweep_mesh(*shape, device_type="cpu")
            for name in ("sweep", "time"):
                x = torch.ones(3)
                dist.all_reduce(x, group=m.get_group(name))
    return dist.get_rank()


def _abort_after_result(marker):
    """Returns its rank, then aborts at interpreter exit, after the rank
    wrote its result; ``marker`` goes to stderr first."""
    import atexit
    print(marker, file=sys.stderr, flush=True)
    atexit.register(os.abort)
    return dist.get_rank()


def test_release_meshes_drops_the_last_reference(tmp_path):
    """One gloo rank in this process: the cached mesh, and with it its
    process groups, is gone after ``release_meshes`` and a collection."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        m = mesh.sweep_mesh(1, 1, device_type="cpu")
        ref = weakref.ref(m)
        del m
        gc.collect()
        assert ref() is not None and mesh._MESHES
        mesh.release_meshes()
        gc.collect()
        assert ref() is None and not mesh._MESHES
    finally:
        mesh.release_meshes()
        dist.destroy_process_group()


def test_ranks_with_cached_meshes_exit_cleanly():
    """Four ranks build N4's meshes and use their groups; every rank exits
    0 in each of four worlds.  Without the release a rank of one world in
    a few aborted at exit, so this test failed most runs."""
    for _ in range(4):
        assert run_world(_sub_group_collectives, 4, (2,), timeout=120) == [
            0, 1, 2, 3]


def test_run_world_reports_a_silent_abort():
    with pytest.raises(RuntimeError) as err:
        run_world(_abort_after_result, 2, ("marker-from-the-rank",),
                  timeout=120)
    text = str(err.value)
    assert "exit -6, result written" in text
    assert "marker-from-the-rank" in text
