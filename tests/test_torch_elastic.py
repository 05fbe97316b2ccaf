"""PyTorch port: elastic band recovery on the CPU (tests/test_elastic.py's
three render cases at its sizes: config1 64², band_rows 16, min_rows 8) —
band worker processes, split-retry and zero-fill under injected faults, each
frame bit-equal to the in-process `render_banded` / `render_ssaa`, and the
fault-free frame against the JAX `render`.
"""

import dataclasses

import numpy as np
import pytest
import torch

from raytracer_tpu.models import presets as ref_presets
from raytracer_tpu.renderer import render as ref_render
from raytracer_tpu_torch.renderer import render_banded, render_ssaa
from raytracer_tpu_torch.utils.elastic import Faults, render_resilient
from raytracer_tpu_torch.utils.hostload import load_scene_cli
from tests.helpers import assert_images_close

torch.set_num_threads(2)

KW = dict(config="config1", width=64, min_rows=8, device="cpu")


@pytest.fixture(autouse=True)
def _few_threads(monkeypatch):
    """Child processes (workers, supervised children) start torch with two
    threads, as this process runs: the suite runs several files at once."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")


@pytest.fixture(scope="module")
def in_process():
    """config1 64² rendered in this process, one band."""
    scene, cam, opts = load_scene_cli("config1", width=64)
    return render_banded(scene, cam, opts, device="cpu")[0].numpy()


def test_fault_free_frame_matches_render_banded_and_jax(in_process):
    img, rep = render_resilient(**KW)     # one band: the whole frame
    assert (rep.bands_ok, rep.bands_failed, rep.retries) == (1, 0, 0)
    assert rep.rays > 0 and not rep.failed_rows
    np.testing.assert_array_equal(img, in_process)
    scene, cam, opts = ref_presets.PRESETS["config1"]()
    opts = dataclasses.replace(opts, width=64, height=64)
    want = np.asarray(ref_render(scene, cam, opts)[0])
    assert_images_close(img, want, tol=1e-4, max_bad_frac=0.004,
                        name="config1 64² resilient")


def test_resilient_recovers_from_transient_faults(tmp_path, in_process):
    """The first two workers crash (countdown): split + re-dispatch still
    give the exact full frame."""
    cd = tmp_path / "countdown.txt"
    cd.write_text("2")
    img, rep = render_resilient(band_rows=16,
                                faults=Faults(countdown_file=str(cd)), **KW)
    assert cd.read_text() == "0"          # both injected faults consumed
    assert rep.bands_failed == 0 and not rep.failed_rows
    assert rep.retries >= 2
    np.testing.assert_array_equal(img, in_process)


def test_resilient_zero_fills_permanent_faults(in_process):
    """A permanently poisoned row range ends as zero-filled terminal pieces
    with every other band exact (a partial frame beats no frame)."""
    img, rep = render_resilient(band_rows=16, faults=Faults(rows=(16, 32)),
                                **KW)
    assert rep.bands_failed == 2          # two terminal 8-row pieces
    assert sorted(rep.failed_rows) == [(16, 8), (24, 8)]
    assert (img[16:32] == 0).all()
    np.testing.assert_array_equal(img[:16], in_process[:16])
    np.testing.assert_array_equal(img[32:], in_process[32:])


def test_resilient_ssaa_recovers_and_averages(tmp_path):
    """--ssaa: the faulted frame equals `render_ssaa` in this process bit
    for bit, and the box average of a raw 2× frame (rtol 1e-6)."""
    scene, cam, opts = load_scene_cli("config1", width=48)
    want = render_ssaa(scene, cam, opts, device="cpu", factor=2)[0].numpy()
    cd = tmp_path / "cd.txt"
    cd.write_text("1")
    kw = dict(KW, width=48)
    img, rep = render_resilient(ssaa=2, band_rows=24,
                                faults=Faults(countdown_file=str(cd)), **kw)
    assert rep.bands_failed == 0 and rep.retries >= 1
    np.testing.assert_array_equal(img, want)
    hi = render_banded(*load_scene_cli("config1", width=96),
                       device="cpu")[0].numpy()
    np.testing.assert_allclose(img, hi.reshape(48, 2, 48, 2, 3).mean(
        axis=(1, 3)), rtol=1e-6, atol=1e-6)


def test_band_worker_needs_the_card_unless_told(tmp_path):
    """A worker without `--device cpu` on a machine without a GPU exits
    with "no CUDA device", and the driver stops instead of splitting."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="no CUDA device") as e:
        render_resilient(config="config1", width=16, device="cuda")
    assert "exit 3" in str(e.value)
