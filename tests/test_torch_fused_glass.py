"""PyTorch port: the fused Whitted forward on the glass Cornell box (config3).

A file of its own so that `--dist loadfile` runs it beside
tests/test_torch_fused.py: the JAX interpret-mode render_plan of config3 at
32² takes tens of seconds on a CPU at depth 2 (7 nodes) and about three
times that at depth 3, so the cross-package check stays at depth 2. The
port's own deeper tree (depth 4, 31 nodes) is held against its wavefront
renderer, as tests/test_fused.py holds the reference's.
"""

import dataclasses

import numpy as np
import torch

from raytracer_tpu.models import presets
from raytracer_tpu.ops import fused as jfused
from raytracer_tpu_torch.ops import fused as tfused
from raytracer_tpu_torch.renderer import render
from tests.helpers import assert_images_close
from tests.test_torch_fused import assert_plans_close
from tests.torch_cases import port

torch.set_num_threads(2)


def test_config3_glass_plan_matches_reference():
    scene, cam, opts = presets.config3_cornell()
    opts = dataclasses.replace(opts, width=32, height=32, max_depth=2)
    want = jfused.FusedWhitted(scene, cam, opts,
                               interpret=True).render_plan()
    fw = tfused.FusedWhitted(*port(scene, cam, opts), device="cpu")
    have = fw.render_plan()
    img, want_img = have[0].numpy(), np.asarray(want[0])
    # glass paths multiply fresnel factors: association noise grows, but a
    # wrong branch or weight would be O(0.5) over whole regions
    assert_images_close(img, want_img, tol=1e-2, max_bad_frac=0.003,
                        name="config3")
    assert np.abs(img - want_img).mean() < 1e-3
    assert_plans_close(want, have, 7)


def test_config3_depth4_matches_wavefront():
    scene, cam, opts = port(*presets.config3_cornell())
    opts = dataclasses.replace(opts, width=40, height=40, max_depth=4)
    fw = tfused.FusedWhitted(scene, cam, opts, device="cpu")
    img, wins, occs = fw.render_plan()
    assert len(wins) == len(occs) == 31
    ref, _ = render(scene, cam, opts, device="cpu")
    assert_images_close(img.numpy(), ref.numpy(), tol=1e-2,
                        max_bad_frac=0.003, name="config3 d4")
    assert float((img - ref).abs().mean()) < 1e-3
